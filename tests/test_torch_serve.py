"""The port's LM serving path (`repro_torch.models.transformer`,
`repro_torch.launch.serve`) against the reference's, at qwen3-1.7b's
reduced width (3 layers, d_model 128, 4 heads, 2 KV heads, head_dim 32,
vocab 512), with the reference's own initial parameters carried across
(`params_from_numpy`) and the same prompts. The reference runs under
`jax.jit`, as its `serve()` does.

Tolerances, and why:
  * float32 configuration: both prefills are float32 throughout and differ
    by summation order (the port's prefill attention is kernel B10's plain
    version, a dense float32 softmax; the reference's is its blocked scan):
    logits within 1e-4. Cache codes agree at a rate >= 0.999: a value
    within float32 noise of a mu-law code boundary lands one code apart.
    Decode logits agree within 2e-2 (measured up to ~5e-3): both packages
    read the ring through bf16 (the reference's `dequantize_block_kmajor`
    default dtype, p cast to it, p@v rounded to it), so float32 summation
    noise now and then moves an attention output by one bf16 step, which
    moves the next layer's token codes by a level; a code one level apart
    at the top of the 7-bit mu-law scale moves a key by ~4 % of its group's
    absmax. Decoding from the reference's own prefill cache, carried across,
    isolates the decode step; the wrap-around case flips codes that way;
  * bfloat16 configuration (the default): the reference's prefill rounds
    scores and p to bf16 in its einsums, B10 keeps them in float32, so the
    two differ by bf16 rounding by design. Logits within 6 % of the largest
    |logit| (measured 1.4 % here, 2.3 % on another prompt), and the port in bf16 is no further from the
    float32 reference than 2x the reference in bf16 is. Layer 0's codes,
    computed before any attention, agree at >= 0.999;
  * greedy tokens of `serve()` equal the reference's in float32; in bf16
    their agreement is a measured rate, pinned (ROADMAP C5).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as rget
from repro.launch import serve as rserve
from repro.models import transformer as rt
from repro_torch.configs import get_arch
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

S, GEN = 150, 4  # a prompt that is not a multiple of the 128-token scale group


def _cfgs(dtype, **kw):
    return (rget("qwen3-1.7b").model.reduced(dtype=dtype, **kw),
            get_arch("qwen3-1.7b").model.reduced(dtype=dtype, **kw))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


class Pair:
    """Reference parameters, their port, jitted reference steps, prompts."""

    def __init__(self, dtype, **kw):
        self.cfg, self.tcfg = _cfgs(dtype, **kw)
        self.params = rt.init_params(self.cfg, jax.random.PRNGKey(0))
        self.tree = jax.tree_util.tree_map(np.asarray, self.params)
        self.model = params_from_numpy(self.tree, self.tcfg, "cpu")
        cfg = self.cfg
        self.prefill = jax.jit(lambda p, x, n: rt.prefill(p, cfg, x, n), static_argnums=2)
        self.decode = jax.jit(lambda p, c, t: rt.decode_step(p, cfg, c, t))
        rng = np.random.default_rng(1)
        self.toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
        self.steps = rng.integers(0, cfg.vocab_size, (GEN, 2, 1)).astype(np.int32)


@pytest.fixture(scope="module")
def f32():
    return Pair("float32")


@pytest.fixture(scope="module")
def bf16():
    return Pair("bfloat16")


def _port_cache(cache_r):
    return {"pos": int(cache_r["pos"]),
            "layers": {k: torch.from_numpy(np.array(v)) for k, v in cache_r["layers"].items()}}


def test_params_carry_across_unchanged(f32):
    back = params_to_numpy(f32.model)
    flat_r, tree_r = jax.tree_util.tree_flatten(f32.tree)
    flat_t, tree_t = jax.tree_util.tree_flatten(back)
    assert tree_r == tree_t
    for a, b in zip(flat_r, flat_t):
        np.testing.assert_array_equal(a, b)
    again = params_from_numpy(back, f32.tcfg, "cpu")
    for (n, a), (_, b) in zip(f32.model.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), n
    bf = params_from_numpy(f32.tree, dataclasses.replace(f32.tcfg, dtype="bfloat16"), "cpu")
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())


def test_unported_configs_raise_naming_the_roadmap():
    """No config of the ten is refused any more (the last two, the
    embedding front ends', are ported): they equal the reference's, an
    unknown arch is still a KeyError, and the three configurations this
    test once saw refused (embeddings with a tied head and 4 kv heads,
    embeddings, a logit softcap) build and give the reference's float32
    forward logits within 1e-4."""
    for arch in ("musicgen-large", "pixtral-12b"):
        assert dataclasses.asdict(get_arch(arch).model) == dataclasses.asdict(rget(arch).model)
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
    rng = np.random.default_rng(2)
    for kw in (dict(input_kind="embeddings", tie_embeddings=True, n_kv_heads=4),
               dict(input_kind="embeddings"), dict(attn_logit_softcap=30.0)):
        cfg, tcfg = _cfgs("float32", n_layers=2, **kw)
        params = rt.init_params(cfg, jax.random.PRNGKey(0))
        model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
        x = (rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32) if cfg.input_kind == "embeddings"
             else rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32))
        want, _ = jax.jit(lambda p, x: rt.forward(p, cfg, x))(params, jnp.asarray(x))
        got, _ = tt.forward(model, tcfg, torch.from_numpy(x))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-4, err_msg=str(kw))


def test_prefill_and_decode_float32(f32):
    cache_r, log_r = f32.prefill(f32.params, jnp.asarray(f32.toks), S + GEN)
    cache_t, log_t = tt.prefill(f32.model, f32.tcfg, torch.from_numpy(f32.toks), S + GEN)
    np.testing.assert_allclose(_np(log_t), np.asarray(log_r), rtol=0, atol=1e-4)
    assert cache_t["pos"] == int(cache_r["pos"]) == S
    for name in ("k_codes", "v_codes"):
        rate = float((cache_t["layers"][name].numpy() == np.asarray(cache_r["layers"][name])).mean())
        print(f"float32 prefill {name}: agreement {rate:.6f}")
        assert rate >= 0.999
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(cache_t["layers"][name].numpy(), np.asarray(cache_r["layers"][name]),
                                   rtol=1e-5)
    # decode from the reference's own prefill cache, carried across
    carried = _port_cache(cache_r)
    cr = cache_r
    for t in f32.steps:
        cr, lr = f32.decode(f32.params, cr, jnp.asarray(t))
        carried, lt = tt.decode_step(f32.model, f32.tcfg, carried, torch.from_numpy(t))
        np.testing.assert_allclose(_np(lt), np.asarray(lr), rtol=0, atol=2e-2)
    # the port's own chain
    for t in f32.steps:
        cache_r, lr = f32.decode(f32.params, cache_r, jnp.asarray(t))
        cache_t, lt = tt.decode_step(f32.model, f32.tcfg, cache_t, torch.from_numpy(t))
        np.testing.assert_allclose(_np(lt), np.asarray(lr), rtol=0, atol=2e-2)
    assert cache_t["pos"] == carried["pos"] == S + GEN


def test_ring_wraps_around_float32(f32):
    """A ring of exactly the prompt's 100 slots (W = 100, one 100-token scale
    group): every decode step overwrites the oldest slot."""
    toks = f32.toks[:, :100]
    cache_r, _ = f32.prefill(f32.params, jnp.asarray(toks), 100)
    cache_t = _port_cache(cache_r)
    assert cache_t["layers"]["k_codes"].shape[2] == 100
    for t in f32.steps:
        cache_r, lr = f32.decode(f32.params, cache_r, jnp.asarray(t))
        cache_t, lt = tt.decode_step(f32.model, f32.tcfg, cache_t, torch.from_numpy(t))
        np.testing.assert_allclose(_np(lt), np.asarray(lr), rtol=0, atol=2e-2)
    rate = float((cache_t["layers"]["k_codes"].numpy() == np.asarray(cache_r["layers"]["k_codes"])).mean())
    assert rate >= 0.999


def test_prefill_and_decode_bfloat16(bf16, f32):
    cache_r, log_r = bf16.prefill(bf16.params, jnp.asarray(bf16.toks), S + GEN)
    cache_t, log_t = tt.prefill(bf16.model, bf16.tcfg, torch.from_numpy(bf16.toks), S + GEN)
    assert log_t.dtype == torch.bfloat16
    lr, lt = np.asarray(log_r, np.float32), _np(log_t)
    scale = np.abs(lr).max()
    err = np.abs(lt - lr).max()
    print(f"bfloat16 prefill logits: max err {err} of max |logit| {scale}")
    assert err <= 0.06 * scale
    _, log_f = f32.prefill(f32.params, jnp.asarray(bf16.toks), S + GEN)
    truth = np.asarray(log_f)
    assert np.abs(lt - truth).max() <= 2 * np.abs(lr - truth).max()
    rate = float((cache_t["layers"]["k_codes"][0].numpy() == np.asarray(cache_r["layers"]["k_codes"][0])).mean())
    assert rate >= 0.999
    for t in bf16.steps:
        cache_r, lr = bf16.decode(bf16.params, cache_r, jnp.asarray(t))
        cache_t, lt = tt.decode_step(bf16.model, bf16.tcfg, cache_t, torch.from_numpy(t))
        lr, lt = np.asarray(lr, np.float32), _np(lt)
        assert np.isfinite(lt).all()
        assert np.abs(lt - lr).max() <= 0.06 * np.abs(lr).max()


def test_serve_tokens_equal_the_reference_float32():
    cfg, tcfg = _cfgs("float32")
    batch, prompt_len, gen, seed = 2, 100, 6, 0
    run_r = rserve.serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=seed)
    key = jax.random.PRNGKey(seed)
    tree = jax.tree_util.tree_map(np.asarray, rt.init_params(cfg, key))
    prompts = np.asarray(jax.random.randint(key, (batch, prompt_len), 0, cfg.vocab_size))
    run_t = tserve.serve(tcfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=seed,
                         device="cpu", params=tree, prompts=prompts)
    np.testing.assert_array_equal(run_t.tokens, run_r.tokens)
    assert run_t.tokens_generated == run_r.tokens_generated == batch * gen
    assert run_t.cache_bytes == run_r.cache_bytes
    assert run_t.cache_bytes_raw_equiv == run_r.cache_bytes_raw_equiv


#: ROADMAP C5: the bf16 greedy tokens of `serve()` against the reference's,
#: 3 seeds x 4 requests x 16 generated: 161 of 192 equal (measured here);
#: a request that diverges stays apart, each side feeding its own token
BF16_TOKEN_AGREEMENT = 161 / 192


def test_serve_tokens_bfloat16_agreement_rate():
    """The bf16 prefill rounds scores and p to bf16 in the reference and
    not in B10, so near-tie greedy tokens can differ (ROADMAP C5). The
    element-wise agreement over the three runs is pinned at its measured
    rate; the first generated tokens (from the prefill alone) agree in 11
    of 12 requests."""
    cfg, tcfg = _cfgs("bfloat16")
    batch, prompt_len, gen = 4, 100, 16
    equal = first = 0
    for seed in (0, 1, 2):
        run_r = rserve.serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=seed)
        key = jax.random.PRNGKey(seed)
        tree = jax.tree_util.tree_map(np.asarray, rt.init_params(cfg, key))
        prompts = np.asarray(jax.random.randint(key, (batch, prompt_len), 0, cfg.vocab_size))
        run_t = tserve.serve(tcfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=seed,
                             device="cpu", params=tree, prompts=prompts)
        same = np.asarray(run_t.tokens) == np.asarray(run_r.tokens)
        equal += int(same.sum())
        first += int(same[:, 0].sum())
    rate = equal / (3 * batch * gen)
    print(f"bfloat16 greedy tokens equal to the reference's: {equal} of {3 * batch * gen} ({rate:.4f}); "
          f"first tokens {first} of {3 * batch}")
    assert rate >= BF16_TOKEN_AGREEMENT
    assert first >= 11


@pytest.mark.parametrize("kw", [dict(kv_quant=False), dict(kv_quant=False, swa_window=16)])
def test_raw_cache_decode_matches_forward(kw):
    """As tests/test_models.py holds the reference: the raw-cache decode of
    the last token equals the forward pass's logits there."""
    _, cfg = _cfgs("float32", **kw)
    model = tt.init_params(cfg, 0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32))
    full, _ = tt.forward(model, cfg, toks)
    cache, log_pre = tt.prefill(model, cfg, toks[:, :23], cache_seq_len=24)
    cache, log_dec = tt.decode_step(model, cfg, cache, toks[:, 23:24])
    torch.testing.assert_close(log_pre[:, 0], full[:, 22], rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(log_dec[:, 0], full[:, 23], rtol=2e-3, atol=2e-3)


def test_serve_main_prints_the_reference_keys(capsys):
    tserve.main(["--device", "cpu", "--batch", "1", "--prompt-len", "8", "--gen", "2"])
    out = json.loads(capsys.readouterr().out)
    assert {"arch", "prefill_s", "decode_tok_per_s", "cache_bytes", "cache_bytes_raw_equiv",
            "kv_compression", "sample_tokens"} <= set(out)
    assert len(out["sample_tokens"]) == 2
