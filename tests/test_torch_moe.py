"""The port's moe family (`repro_torch.models.moe`, the `MoEBlock`s of
`repro_torch.models.transformer`, the moe and the remaining dense configs)
against the reference's, on the same numpy inputs at reduced size, the
reference run under `jax.jit` as its own tests and its `serve()` run it.

Tolerances, and why:
  * `capacity` and `_dispatch_indices` are integers: equal;
  * `moe_ffn` in float32: the routing (`sel`) equal, y within 1e-5 and aux
    within 1e-6 (float32 products over d_model 128 and d_ff 256 summed in
    another order); gradients within 1e-4 in relative norm;
  * `moe_ffn` in bf16: within one bf16 step, rtol = atol = 2^-7, as the
    dense layers are held (XLA fuses the bf16 SwiGLU's elementwise ops in
    float32, torch rounds after each);
  * `loss_fn` and three `make_train_step` steps: as `test_torch_train.py`
    holds the dense family (loss 1e-5 relative, gradients 1e-4 in relative
    norm; parameters' mean difference 1e-6, at most 0.1 % of a leaf's
    elements more than 1e-5 apart);
  * serving in float32: as `test_torch_serve.py` holds the dense family
    (prefill logits within 1e-4, ring codes equal at >= 0.999, greedy
    tokens equal); in bf16 the greedy tokens' agreement is a measured
    rate, pinned (ROADMAP C5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as rget
from repro.launch import serve as rserve
from repro.launch import steps as rsteps
from repro.models import moe as rmoe
from repro.models import transformer as rt
from repro.optim import AdamWConfig as RAdamWConfig
from repro_torch.configs import arch_ids, get_arch
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.models.convert import named_to_tree, params_from_numpy, params_to_numpy
from repro_torch.optim import AdamWConfig

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

MOE_ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x7b")
DENSE_ARCHS = ("deepseek-coder-33b", "mistral-nemo-12b", "phi4-mini-3.8b")
#: the wider variant: 16 experts, top-8, half the capacity, so pairs drop
WIDE = dict(n_experts=16, n_experts_per_token=8, capacity_factor=0.5)


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return rget(arch).model.reduced(**kw), get_arch(arch).model.reduced(**kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _moe_params(cfg, seed: int, zero_router: bool = False):
    """The reference's `init_moe` numbers as numpy leaves."""
    p = jax.tree_util.tree_map(np.asarray, rmoe.init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32))
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    return p


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


# ------------------------------------------------------------- registry --
def test_get_arch_returns_the_ported_configs():
    for arch in MOE_ARCHS + DENSE_ARCHS:
        assert arch in arch_ids()
        assert dataclasses.asdict(get_arch(arch).model) == dataclasses.asdict(rget(arch).model)
        assert get_arch(arch).source == rget(arch).source
        assert get_arch(arch).skips == rget(arch).skips
    assert get_arch("qwen3-moe-30b-a3b").model.param_count() == rget("qwen3-moe-30b-a3b").model.param_count()


@pytest.mark.parametrize("arch,family", [("musicgen-large", "dense"), ("pixtral-12b", "dense")])
def test_ssm_and_hybrid_still_refused(arch, family):
    """Nothing is refused any more: the ssm and hybrid families are ported
    (tests/test_torch_recurrent.py) and so are the embedding front ends'
    configs, which equal the reference's. The moe family, and `family`,
    the front ends' own, run on (B, S, D) embeddings: float32 logits
    within 1e-4 and the aux loss within 1e-6 a layer of the reference's
    forward."""
    assert dataclasses.asdict(get_arch(arch).model) == dataclasses.asdict(rget(arch).model)
    emb = np.random.default_rng(3).normal(size=(2, 24, 128)).astype(np.float32)
    for fam in ("moe", family):
        cfg, tcfg = _cfgs("qwen3-moe-30b-a3b", family=fam, input_kind="embeddings")
        params = rt.init_params(cfg, jax.random.PRNGKey(1))
        model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
        want, aux = jax.jit(lambda p, x: rt.forward(p, cfg, x))(params, jnp.asarray(emb))
        got, taux = tt.forward(model, tcfg, _t(emb))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-4, err_msg=fam)
        assert abs(taux.item() - float(aux)) <= 1e-6 * cfg.n_layers, fam


def test_transformer_builds_moe_blocks():
    _, tcfg = _cfgs("qwen3-moe-30b-a3b")
    model = tt.init_params(tcfg, 0, "cpu")
    assert all(isinstance(b, tt.MoEBlock) for b in model.layers)
    moe = model.layers[0].moe
    d, f, e = tcfg.d_model, tcfg.d_ff, tcfg.n_experts
    assert (moe.router.shape, moe.w_gate.shape, moe.w_up.shape, moe.w_down.shape) == \
        ((d, e), (e, d, f), (e, d, f), (e, f, d))
    # every weight of two or more dims drawn at 1/sqrt(shape[-2]); none left at zero
    for name in ("router", "w_gate", "w_up", "w_down"):
        w = getattr(moe, name)
        assert abs(float(w.std()) * np.sqrt(w.shape[-2]) - 1.0) < 0.1, name


# -------------------------------------------------------------- integers --
@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0, 1.1])
def test_capacity_equals_the_reference(cf):
    cfg = rget("qwen3-moe-30b-a3b").model
    for t in (1, 2, 4, 7, 64, 100, 512, 1000, 8192):
        for e, k in ((4, 2), (8, 2), (16, 8), (128, 8)):
            c = dataclasses.replace(cfg, n_experts=e, n_experts_per_token=k, capacity_factor=cf)
            assert tmoe.capacity(t, c) == rmoe.capacity(t, c), (t, e, k, cf)


@pytest.mark.parametrize("n,e,cap,seed", [(64, 4, 8, 0), (200, 8, 16, 1), (512, 16, 24, 2),
                                          (1000, 128, 8, 3), (48, 4, 100, 4)])
def test_dispatch_indices_equal_the_reference(n, e, cap, seed):
    sel = np.random.default_rng(seed).integers(0, e, n).astype(np.int32)
    sel[: n // 4] = 0  # an overloaded expert: overflow
    want = jax.jit(rmoe._dispatch_indices, static_argnums=(1, 2))(sel, e, cap)
    got = tmoe._dispatch_indices(_t(sel), e, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((got[1] == cap).sum()) > 0 or cap >= n


# --------------------------------------------------------------- moe_ffn --
MOE_CASES = {
    "qwen3-moe": ("qwen3-moe-30b-a3b", {}, False),
    "wide-drops": ("qwen3-moe-30b-a3b", WIDE, False),
    "zero-router": ("qwen3-moe-30b-a3b", {}, True),
    "wide-zero-router": ("qwen3-moe-30b-a3b", WIDE, True),
    "mixtral": ("mixtral-8x7b", {}, False),
}


def _ffn_pair(case, dtype):
    arch, kw, zero = MOE_CASES[case]
    cfg, tcfg = _cfgs(arch, dtype=dtype, **kw)
    p = _moe_params(cfg, 3, zero)
    x = np.random.default_rng(5).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    return cfg, tcfg, p, x


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_float32(case):
    cfg, tcfg, p, x = _ffn_pair(case, "float32")
    y_r, aux_r = jax.jit(lambda p, x: rmoe.moe_ffn(p, cfg, x))(p, x)
    y_t, aux_t = tmoe.moe_ffn({k: _t(v) for k, v in p.items()}, tcfg, _t(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), rtol=0, atol=1e-5)
    assert abs(float(aux_t) - float(aux_r)) <= 1e-6
    xt = x.reshape(-1, cfg.d_model)
    logits = xt @ p["router"]
    _, sel_r = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), axis=-1), cfg.n_experts_per_token)
    _, sel_t, _, _ = tmoe.route(_t(p["router"]), tcfg, _t(xt))
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_r))
    cap = tmoe.capacity(xt.shape[0], tcfg)
    e_t, slot_t = tmoe._dispatch_indices(sel_t.reshape(-1), tcfg.n_experts, cap)
    e_r, slot_r = rmoe._dispatch_indices(sel_r.reshape(-1), cfg.n_experts, cap)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_r))
    np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_r))
    dropped = int((slot_t == cap).sum())
    if case in ("wide-drops", "zero-router", "wide-zero-router"):
        assert dropped > 0, "the case must drop pairs"
    if "zero" in case:  # ties: every token takes experts 0..k-1
        assert (sel_t == torch.arange(tcfg.n_experts_per_token)).all()


@pytest.mark.parametrize("case", ["qwen3-moe", "wide-drops", "zero-router", "mixtral"])
def test_moe_ffn_bfloat16(case):
    cfg, tcfg, p, x = _ffn_pair(case, "bfloat16")
    pb = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p.items()}  # the reference's `_cast`
    y_r, aux_r = jax.jit(lambda p, x: rmoe.moe_ffn(p, cfg, x))(pb, jnp.asarray(x).astype(jnp.bfloat16))
    y_t, aux_t = tmoe.moe_ffn({k: _t(v).bfloat16() for k, v in p.items()}, tcfg, _t(x).bfloat16())
    assert y_t.dtype == torch.bfloat16
    tol = 2.0**-7
    np.testing.assert_allclose(_np(y_t), np.asarray(y_r, np.float32), rtol=tol, atol=tol)
    assert abs(float(aux_t) - float(aux_r)) <= 1e-6


@pytest.mark.parametrize("case", ["qwen3-moe", "wide-drops", "mixtral"])
def test_moe_ffn_gradients(case):
    cfg, tcfg, p, x = _ffn_pair(case, "float32")
    g = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)

    def loss_r(p, x):
        y, aux = rmoe.moe_ffn(p, cfg, x)
        return jnp.sum(y * g) + 0.5 * aux

    gp_r, gx_r = jax.jit(jax.grad(loss_r, (0, 1)))(p, x)
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tx = _t(x).requires_grad_()
    y, aux = tmoe.moe_ffn(tp, tcfg, tx)
    (torch.sum(y * _t(g)) + 0.5 * aux).backward()
    assert _rel(tx.grad.numpy(), gx_r) < 1e-4
    for k in p:
        assert _rel(tp[k].grad.numpy(), gp_r[k]) < 1e-4, k


def test_moe_ffn_gradient_of_dropped_pairs_is_zero():
    """A pair at the sentinel slot contributes nothing, nor gets a gradient:
    with the zero router, dropped tokens' x gradient comes from the router
    alone."""
    cfg, tcfg, p, x = _ffn_pair("zero-router", "float32")
    tp = {k: _t(v) for k, v in p.items()}
    tx = _t(x).requires_grad_()
    y, _ = tmoe.moe_ffn(tp, tcfg, tx)
    t = x.shape[0] * x.shape[1]
    cap = tmoe.capacity(t, tcfg)
    kept = (torch.arange(t) < cap)  # experts 0..k-1 take the first `cap` tokens
    assert (y.reshape(t, -1)[~kept] == 0).all() and (y.reshape(t, -1)[kept] != 0).any()
    y.sum().backward()
    assert (tx.grad.reshape(t, -1)[~kept] == 0).all()


# ------------------------------------------------------- the whole model --
@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_pair(request):
    cfg, tcfg = _cfgs(request.param, n_layers=2)
    params = rt.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 25)).astype(np.int32)
    return cfg, tcfg, params, tree, toks


def test_params_carry_across_both_ways(moe_pair):
    _, tcfg, _, tree, _ = moe_pair
    for param_dtype in (None, "float32"):
        model = params_from_numpy(tree, tcfg, "cpu", param_dtype=param_dtype)
        back = params_to_numpy(model)
        flat_r, def_r = jax.tree_util.tree_flatten(tree)
        flat_t, def_t = jax.tree_util.tree_flatten(back)
        assert def_r == def_t
        for a, b in zip(flat_r, flat_t):
            np.testing.assert_array_equal(a, b)
    names = {k: 0 for k, _ in model.named_parameters()}
    assert jax.tree_util.tree_structure(named_to_tree(names)) == jax.tree_util.tree_structure(tree)
    assert "layers.1.moe.router" in names


@pytest.mark.parametrize("remat", ["none", "full"])
def test_forward_and_loss_with_aux_match_the_reference(moe_pair, remat):
    cfg, tcfg, params, tree, toks = moe_pair
    cfg, tcfg = dataclasses.replace(cfg, remat=remat), dataclasses.replace(tcfg, remat=remat)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    (loss, m), g = jax.jit(jax.value_and_grad(lambda p, b: rt.loss_fn(p, cfg, b), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = params_from_numpy(tree, tcfg, "cpu", param_dtype="float32")
    tloss, tm = tt.loss_fn(model, tcfg, {k: _t(v) for k, v in batch.items()})
    tloss.backward()
    assert float(m["aux"]) > 0
    assert abs(tm["aux"].item() - float(m["aux"])) <= 1e-6 * cfg.n_layers
    assert abs(tloss.item() - float(loss)) <= 1e-5 * abs(float(loss))
    grads = named_to_tree({k: p.grad.numpy() for k, p in model.named_parameters()})
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, g))[0]:
        assert _rel(_leaf(grads, path), leaf) < 1e-4, "/".join(k.key for k in path)


def test_make_train_step_three_steps_match_the_reference():
    cfg, tcfg = _cfgs("qwen3-moe-30b-a3b", n_layers=2)
    params = rt.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    mb = 2
    rng = np.random.default_rng(9)
    batches = [rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32) for _ in range(3)]
    opt = dict(lr=1e-2, weight_decay=0.1)
    from repro.optim import adamw as radamw
    from repro.optim.schedules import warmup_cosine as rwc
    from repro_torch.optim import adamw as tadamw
    from repro_torch.optim.schedules import warmup_cosine as twc

    _, r_step = rsteps.make_train_step(cfg, RAdamWConfig(schedule=rwc(1, 3), **opt),
                                       rsteps.TrainStepConfig(microbatches=mb))
    r_step = jax.jit(r_step)
    _, t_step = tsteps.make_train_step(tcfg, AdamWConfig(schedule=twc(1, 3), **opt),
                                       tsteps.TrainStepConfig(microbatches=mb), device="cpu")
    r_params, r_opt = params, radamw(RAdamWConfig(**opt))[0](params)
    model = params_from_numpy(tree, tcfg, "cpu", param_dtype="float32")
    t_opt = tadamw(AdamWConfig(**opt))[0](dict(model.named_parameters()))
    for toks in batches:
        rb = rsteps.microbatch_split({"inputs": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}, mb)
        tb = tsteps.microbatch_split({"inputs": _t(toks[:, :-1]), "labels": _t(toks[:, 1:])}, mb)
        r_params, r_opt, rm = r_step(r_params, r_opt, rb)
        model, t_opt, tm = t_step(model, t_opt, tb)
        for k in ("loss", "ce"):
            assert abs(float(tm[k]) - float(rm[k])) <= 1e-5 * abs(float(rm[k])), k
        assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= 1e-4 * float(rm["grad_norm"])
    got = params_to_numpy(model)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, r_params))[0]:
        d = np.abs(_leaf(got, path) - leaf)
        far = float((d > 1e-5).mean())
        assert far <= 1e-3 and d.mean() <= 1e-6, ("/".join(k.key for k in path), d.max(), d.mean(), far)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_pick_microbatches_equals_the_reference(arch):
    for gb, seq, ds in ((256, 4096, 16), (8, 128, 1), (64, 2048, 4)):
        assert tsteps.pick_microbatches(get_arch(arch).model, gb, seq, ds) == \
            rsteps.pick_microbatches(rget(arch).model, gb, seq, ds)


# ---------------------------------------------------------------- serving --
def _serve_pair(arch, dtype, batch, prompt_len, gen, seed):
    cfg, tcfg = _cfgs(arch, dtype=dtype)
    run_r = rserve.serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=seed)
    key = jax.random.PRNGKey(seed)
    tree = jax.tree_util.tree_map(np.asarray, rt.init_params(cfg, key))
    prompts = np.asarray(jax.random.randint(key, (batch, prompt_len), 0, cfg.vocab_size))
    run_t = tserve.serve(tcfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=seed,
                         device="cpu", params=tree, prompts=prompts)
    return cfg, tree, prompts, run_r, run_t


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_logits_and_ring_codes_float32(arch):
    """mixtral's reduced window is 64: an 80-token prompt wraps its ring."""
    cfg, tcfg = _cfgs(arch)
    params = rt.init_params(cfg, jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    s, gen = 80, 4
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    cache_r, log_r = jax.jit(lambda p, x: rt.prefill(p, cfg, x, s + gen))(params, jnp.asarray(toks))
    cache_t, log_t = tt.prefill(model, tcfg, _t(toks), s + gen)
    np.testing.assert_allclose(_np(log_t), np.asarray(log_r), rtol=0, atol=1e-4)
    w = cache_t["layers"]["k_codes"].shape[2]
    assert w == np.asarray(cache_r["layers"]["k_codes"]).shape[2] == (64 if cfg.swa_window else s + gen)
    for name in ("k_codes", "v_codes"):
        rate = float((cache_t["layers"][name].numpy() == np.asarray(cache_r["layers"][name])).mean())
        assert rate >= 0.999, (name, rate)
    decode = jax.jit(lambda p, c, t: rt.decode_step(p, cfg, c, t))
    for t in np.random.default_rng(2).integers(0, cfg.vocab_size, (gen, 2, 1)).astype(np.int32):
        cache_r, lr = decode(params, cache_r, jnp.asarray(t))
        cache_t, lt = tt.decode_step(model, tcfg, cache_t, _t(t))
        np.testing.assert_allclose(_np(lt), np.asarray(lr), rtol=0, atol=2e-2)


@pytest.mark.parametrize("arch", MOE_ARCHS + DENSE_ARCHS)
def test_serve_tokens_equal_the_reference_float32(arch):
    prompt_len = 80 if arch == "mixtral-8x7b" else 100
    cfg, _, _, run_r, run_t = _serve_pair(arch, "float32", 2, prompt_len, 6, 0)
    np.testing.assert_array_equal(run_t.tokens, run_r.tokens)
    assert run_t.cache_bytes == run_r.cache_bytes
    assert run_t.cache_bytes_raw_equiv == run_r.cache_bytes_raw_equiv


#: ROADMAP C5 for the moe family: the bf16 greedy tokens of `serve()`
#: against the reference's, 2 seeds x 4 requests x 16 generated: qwen3-moe
#: 104 of 128, mixtral 82 of 128 (measured on the CPU). A request that
#: diverges stays apart, each side feeding its own token. The moe family
#: agrees less often than the dense one (161 of 192): a bf16 difference
#: before a router can send a token to another expert
BF16_TOKEN_AGREEMENT = {"qwen3-moe-30b-a3b": 104 / 128, "mixtral-8x7b": 82 / 128}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_tokens_bfloat16_agreement_rate(arch):
    equal = 0
    for seed in (0, 1):
        _, _, _, run_r, run_t = _serve_pair(arch, "bfloat16", 4, 80, 16, seed)
        equal += int((np.asarray(run_t.tokens) == np.asarray(run_r.tokens)).sum())
    rate = equal / (2 * 4 * 16)
    print(f"{arch} bfloat16 greedy tokens equal to the reference's: {equal} of {2 * 4 * 16} ({rate:.4f})")
    assert rate >= BF16_TOKEN_AGREEMENT[arch]


def test_serve_main_runs_the_moe_config_reduced(capsys):
    import json

    tserve.main(["--arch", "qwen3-moe-30b-a3b", "--device", "cpu", "--batch", "2", "--prompt-len", "16",
                 "--gen", "3"])
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "qwen3-moe-30b-a3b" and len(out["sample_tokens"]) == 3
