"""The port's ssm and hybrid families (`repro_torch.models.rglru`,
`repro_torch.models.ssd`, the `SSMBlock`/`RecSublayer`/`HybridGroup`
blocks of `repro_torch.models.transformer`, the mamba2-1.3b and
recurrentgemma-9b configs) against the reference's, on the same numpy
inputs at reduced size, the reference run under `jax.jit` as its own tests
and its `serve()` run it.

Tolerances, and why:
  * `causal_conv1d` in float32: within 1e-6 (W products and a bias summed
    in the same order; XLA may fuse a multiply-add), the tail equal;
  * `_lru_scan` in float32: within 1e-5 relative to max |h| (the same
    odd/even recursion, so the same products, but XLA may contract
    b_l a_r + b_r into one FMA and the port rounds twice); at S = 4,096
    also within 1e-4 of a float64 sequential loop (no underflow);
  * `rglru_apply`, `mamba2_apply` and `mamba2_decode` in float32: outputs,
    states and conv tails within 2e-5 (float32 products over d_model 128,
    and the SSD's contractions formed pairwise here, as one four-operand
    einsum there: summation order);
  * `loss_fn` and three `make_train_step` steps: as `test_torch_train.py`
    holds the dense family (loss 1e-5 relative, gradients 1e-4 in relative
    norm; parameters' mean difference 1e-6, at most 0.1 % of a leaf's
    elements more than 1e-5 apart), with one element allowed in a leaf of
    fewer than 1,000 (the RG-LRU's 128-wide biases: AdamW's early steps
    divide a near-zero gradient by its own root, so a float32 sum in
    another order moves such an element by ~1.5e-5 at lr 1e-2);
  * serving in float32: prefill logits within 1e-4, every recurrent state
    and conv tail within 1e-4, ring codes equal at >= 0.999 (a float32
    difference can move a value across a mu-law threshold), decode logits
    within 2e-2 of the reference's, greedy tokens equal; in bf16 the greedy
    tokens' agreement is a measured rate, pinned (ROADMAP C5).
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
from repro.models import rglru as rrglru
from repro.models import ssd as rssd
from repro.models import transformer as rt
from repro.optim import AdamWConfig as RAdamWConfig
from repro_torch.configs import arch_ids, get_arch
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import rglru as trglru
from repro_torch.models import ssd as tssd
from repro_torch.models import transformer as tt
from repro_torch.models.convert import named_to_tree, params_from_numpy, params_to_numpy
from repro_torch.optim import AdamWConfig

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

ARCHS = ("mamba2-1.3b", "recurrentgemma-9b")


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return rget(arch).model.reduced(**kw), get_arch(arch).model.reduced(**kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------- registry --
@pytest.mark.parametrize("arch", ARCHS)
def test_get_arch_returns_the_ported_config(arch):
    assert arch in arch_ids()
    assert dataclasses.asdict(get_arch(arch).model) == dataclasses.asdict(rget(arch).model)
    assert get_arch(arch).source == rget(arch).source
    assert get_arch(arch).model.param_count() == rget(arch).model.param_count()


@pytest.mark.parametrize("arch", ["musicgen-large", "pixtral-12b"])
def test_front_end_configs_still_refused(arch):
    """The front ends' configs are ported now and equal the reference's;
    the ssm and hybrid families run on (B, S, D) embeddings as well:
    float32 logits within 1e-4 of the reference's forward."""
    assert dataclasses.asdict(get_arch(arch).model) == dataclasses.asdict(rget(arch).model)
    emb = np.random.default_rng(4).normal(size=(2, 40, 128)).astype(np.float32)
    for fam_arch in ARCHS:
        cfg, tcfg = _cfgs(fam_arch, input_kind="embeddings")
        params = rt.init_params(cfg, jax.random.PRNGKey(2))
        model = params_from_numpy(_np_tree(params), tcfg, "cpu")
        want, _ = jax.jit(lambda p, x: rt.forward(p, cfg, x))(params, jnp.asarray(emb))
        got, _ = tt.forward(model, tcfg, _t(emb))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-4, err_msg=fam_arch)


def test_transformer_builds_both_families_at_full_width():
    """The full configs build on the meta device (no memory): mamba2's 48
    SSMBlocks, recurrentgemma's 12 groups and 2-layer tail, and the
    parameter counts the reference states."""
    for arch in ARCHS:
        cfg = get_arch(arch).model
        model = tt.Transformer(cfg, "meta")
        n = sum(p.numel() for p in model.parameters())
        assert n == sum(np.prod(l.shape) for l in jax.tree_util.tree_leaves(
            jax.eval_shape(lambda k: rt.init_params(rget(arch).model, k),
                           jax.random.PRNGKey(0))))
        if arch == "mamba2-1.3b":
            assert len(model.layers) == 48 and all(isinstance(b, tt.SSMBlock) for b in model.layers)
        else:
            assert (len(model.groups), len(model.tail)) == (12, 2)
            assert model.groups[0].attn.wq.shape == (4096, 16 * 256)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_distributions(arch):
    _, tcfg = _cfgs(arch, d_model=256)
    model = tt.init_params(tcfg, 0, "cpu")
    mods = [m for m in model.modules() if isinstance(m, (trglru.RGLRU, tssd.Mamba2))]
    assert mods
    for m in mods:
        assert abs(float(m.conv_w.std()) - 0.1) < 0.02
        assert float(m.conv_b.abs().max()) == 0.0
    if arch == "recurrentgemma-9b":
        lam = torch.cat([m.lam for m in mods])
        a = torch.sigmoid(lam) ** trglru.C_SCALE
        assert float(a.min()) >= 0.9 - 1e-4 and float(a.max()) <= 0.999 + 1e-4
        w = model.groups[0].rec1.rglru.w_a
        assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.1
    else:
        m = mods[0]
        a = torch.exp(m.A_log)
        assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
        assert torch.equal(m.D, torch.ones_like(m.D))
        dt0 = torch.nn.functional.softplus(m.dt_bias)
        assert float(dt0.min()) >= 1e-3 * 0.999 and float(dt0.max()) <= 0.1 * 1.001


# ------------------------------------------------------------------ rglru --
@pytest.mark.parametrize("s,width", [(1, 4), (7, 4), (33, 3)])
def test_causal_conv1d_with_a_carried_tail(s, width):
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, 16)).astype(np.float32)
    w = rng.normal(size=(width, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    tail = rng.normal(size=(2, width - 1, 16)).astype(np.float32)
    fn = jax.jit(rrglru.causal_conv1d)
    for t in (None, tail):
        y_r, tail_r = fn(x, w, b, t)
        y_t, tail_t = trglru.causal_conv1d(_t(x), _t(w), _t(b), None if t is None else _t(t))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tail_t.numpy(), np.asarray(tail_r))
    # two calls carrying the tail equal one call over both halves
    h = s // 2 + 1
    y1, t1 = trglru.causal_conv1d(_t(x[:, :h]), _t(w), _t(b))
    y2, _ = trglru.causal_conv1d(_t(x[:, h:]), _t(w), _t(b), t1)
    whole, _ = trglru.causal_conv1d(_t(x), _t(w), _t(b))
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), whole, rtol=0, atol=1e-6)


def _scan_inputs(s, seed, r=8):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.9, 0.999, size=(2, s, r)).astype(np.float32)
    bx = (rng.normal(size=(2, s, r)) * np.sqrt(1 - a.astype(np.float64) ** 2)).astype(np.float32)
    h0 = rng.normal(size=(2, r)).astype(np.float32)
    return a, bx, h0


@pytest.mark.parametrize("s", [1, 2, 5, 97, 4096])
def test_lru_scan_matches_the_reference(s):
    a, bx, h0 = _scan_inputs(s, s)
    want = np.asarray(jax.jit(rrglru._lru_scan)(a, bx, h0))
    got = trglru._lru_scan(_t(a), _t(bx), _t(h0)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale, np.abs(got - want).max()
    if s == 4096:  # against a sequential float64 loop: no underflow, no drift
        h = h0.astype(np.float64)
        seq = np.empty((2, s, a.shape[2]))
        for t in range(s):
            h = a[:, t].astype(np.float64) * h + bx[:, t]
            seq[:, t] = h
        assert np.abs(got - seq).max() <= 1e-4 * np.abs(seq).max()
        assert np.isfinite(got).all()


def _rglru_params(d, r, width, seed):
    p = _np_tree(rrglru.init_rglru(jax.random.PRNGKey(seed), d, r, width, jnp.float32))
    rng = np.random.default_rng(seed)
    for k in ("conv_b", "b_a", "b_x"):  # non-zero biases, so they are exercised
        p[k] = (rng.normal(size=p[k].shape) * 0.1).astype(np.float32)
    return p


@pytest.mark.parametrize("s", [1, 19, 64])
def test_rglru_apply_matches_the_reference(s):
    p = _rglru_params(32, 48, 4, 3)
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, 32)).astype(np.float32)
    h0 = rng.normal(size=(2, 48)).astype(np.float32)
    tail = rng.normal(size=(2, 3, 48)).astype(np.float32)
    y_r, h_r, t_r = jax.jit(rrglru.rglru_apply)(p, x, h0, tail)
    y_t, h_t, t_t = trglru.rglru_apply({k: _t(v) for k, v in p.items()}, _t(x), _t(h0), _t(tail))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), rtol=0, atol=2e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_r), rtol=0, atol=2e-5)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_r), rtol=0, atol=2e-5)


# -------------------------------------------------------------------- ssd --
def _mamba_pair(seed=0):
    cfg, tcfg = _cfgs("mamba2-1.3b")
    p = _np_tree(rssd.init_mamba2(jax.random.PRNGKey(seed), cfg, jnp.float32))
    p["norm"] = (np.random.default_rng(seed).normal(size=p["norm"].shape) * 0.1).astype(np.float32)
    return cfg, tcfg, p, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("s", [16, 37, 5])
def test_mamba2_apply_matches_the_reference(s):
    """S = 37 is not a multiple of ssm_chunk (16): the last chunk is padded;
    S = 5 is shorter than a chunk."""
    cfg, tcfg, p, tp = _mamba_pair()
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    h0 = np.asarray(rssd.init_ssm_state(2, cfg)) + rng.normal(size=(2, 1, 8, 32, 32)).astype(np.float32) * 0.1
    tail = rng.normal(size=(2, cfg.conv_width - 1, tssd.conv_dim(tcfg))).astype(np.float32)
    y_r, h_r, t_r = jax.jit(lambda p, x, h, t: rssd.mamba2_apply(p, cfg, x, h, t))(p, x, h0, tail)
    y_t, h_t, t_t = tssd.mamba2_apply(tp, tcfg, _t(x), _t(h0), _t(tail))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), rtol=0, atol=2e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_r), rtol=0, atol=2e-5)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_r), rtol=0, atol=2e-5)


def test_mamba2_decode_matches_the_reference_and_the_scan():
    """Three decode steps against the reference's, and against
    `mamba2_apply` over the same three tokens from the same state."""
    cfg, tcfg, p, tp = _mamba_pair(1)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    h_r = h0 = rng.normal(size=(2, 1, 8, 32, 32)).astype(np.float32) * 0.1
    t_r = tail = rng.normal(size=(2, cfg.conv_width - 1, tssd.conv_dim(tcfg))).astype(np.float32)
    h_t, t_t = _t(h0), _t(tail)
    dec = jax.jit(lambda p, x, h, t: rssd.mamba2_decode(p, cfg, x, h, t))
    ys = []
    for i in range(3):
        y_r, h_r, t_r = dec(p, x[:, i:i + 1], h_r, t_r)
        y_t, h_t, t_t = tssd.mamba2_decode(tp, tcfg, _t(x[:, i:i + 1]), h_t, t_t)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), rtol=0, atol=2e-5)
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_r), rtol=0, atol=2e-5)
        ys.append(y_t)
    y_s, h_s, _ = tssd.mamba2_apply(tp, tcfg, _t(x), _t(h0), _t(tail))
    torch.testing.assert_close(torch.cat(ys, dim=1), y_s, rtol=0, atol=2e-5)
    torch.testing.assert_close(h_t, h_s, rtol=0, atol=2e-5)


# ------------------------------------------------------- the whole model --
@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg, tcfg = _cfgs(request.param)
    params = rt.init_params(cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 41)).astype(np.int32)
    return cfg, tcfg, params, _np_tree(params), toks


def test_params_carry_across_both_ways(pair):
    _, tcfg, _, tree, _ = pair
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


@pytest.mark.parametrize("remat", ["none", "full"])
def test_forward_and_loss_gradients_match_the_reference(pair, remat):
    cfg, tcfg, params, tree, toks = pair
    cfg, tcfg = dataclasses.replace(cfg, remat=remat), dataclasses.replace(tcfg, remat=remat)
    logits_r, _ = jax.jit(lambda p, x: rt.forward(p, cfg, x))(params, jnp.asarray(toks))
    model = params_from_numpy(tree, tcfg, "cpu", param_dtype="float32")
    with torch.no_grad():
        logits_t, aux = tt.forward(model, tcfg, _t(toks))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_r), rtol=0, atol=1e-4)
    assert float(aux) == 0.0
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    (loss, _), g = jax.jit(jax.value_and_grad(lambda p, b: rt.loss_fn(p, cfg, b), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, _ = tt.loss_fn(model, tcfg, {k: _t(v) for k, v in batch.items()})
    tloss.backward()
    assert abs(tloss.item() - float(loss)) <= 1e-5 * abs(float(loss))
    grads = named_to_tree({k: p.grad.numpy() for k, p in model.named_parameters()})
    for path, leaf in jax.tree_util.tree_flatten_with_path(_np_tree(g))[0]:
        assert _rel(_leaf(grads, path), leaf) < 1e-4, "/".join(k.key for k in path)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_step_three_steps_match_the_reference(arch):
    cfg, tcfg = _cfgs(arch)
    params = rt.init_params(cfg, jax.random.PRNGKey(0))
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
    model = params_from_numpy(_np_tree(params), tcfg, "cpu", param_dtype="float32")
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
    for path, leaf in jax.tree_util.tree_flatten_with_path(_np_tree(r_params))[0]:
        d = np.abs(_leaf(got, path) - leaf)
        far = int((d > 1e-5).sum())
        assert far <= max(1, 1e-3 * d.size) and d.mean() <= 1e-6, ("/".join(k.key for k in path), d.max(),
                                                                  d.mean(), far)


# ---------------------------------------------------------------- serving --
def _cache_leaves(cache_r, cache_t):
    """(path, reference leaf, port leaf) for every tensor of the cache."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache_r)[0]:
        if path[-1].key == "pos":
            continue
        yield "/".join(k.key for k in path), np.asarray(leaf), _leaf(cache_t, path).numpy()


def test_prefill_and_decode_states_float32(pair):
    """An 80-token prompt: recurrentgemma's reduced window is 64, so its
    ring wraps; every state, conv tail and ring code after the prefill and
    after each of 4 decode steps."""
    cfg, tcfg, params, tree, _ = pair
    model = params_from_numpy(tree, tcfg, "cpu")
    s, gen = 80, 4
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    cache_r, log_r = jax.jit(lambda p, x: rt.prefill(p, cfg, x, s + gen))(params, jnp.asarray(toks))
    cache_t, log_t = tt.prefill(model, tcfg, _t(toks), s + gen)
    np.testing.assert_allclose(_np(log_t), np.asarray(log_r), rtol=0, atol=1e-4)
    if cfg.family == "hybrid":
        assert cache_t["groups"]["attn"]["k_codes"].shape[2] == cfg.local_window < s
    decode = jax.jit(lambda p, c, t: rt.decode_step(p, cfg, c, t))
    steps = np.random.default_rng(2).integers(0, cfg.vocab_size, (gen, 2, 1)).astype(np.int32)
    for i in range(gen + 1):
        names = []
        for name, want, got in _cache_leaves(cache_r, cache_t):
            names.append(name)
            assert got.shape == want.shape and got.dtype == want.dtype, name
            if got.dtype == np.uint8:
                assert float((got == want).mean()) >= 0.999, name
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=name)
        assert cache_t["pos"] == int(cache_r["pos"]) == s + i
        if i == gen:
            break
        cache_r, lr = decode(params, cache_r, jnp.asarray(steps[i]))
        cache_t, lt = tt.decode_step(model, tcfg, cache_t, _t(steps[i]))
        np.testing.assert_allclose(_np(lt), np.asarray(lr), rtol=0, atol=2e-2)
    want_names = ({"layers/conv_tail", "layers/ssm_state"} if cfg.family == "ssm" else
                  {f"groups/{r}/{k}" for r in ("rec1", "rec2") for k in ("h", "conv_tail")}
                  | {f"groups/attn/{k}" for k in ("k_codes", "v_codes", "k_scale", "v_scale")}
                  | {"tail/h", "tail/conv_tail"})
    assert set(names) == want_names


def _serve_pair(arch, dtype, batch, prompt_len, gen, seed):
    cfg, tcfg = _cfgs(arch, dtype=dtype)
    run_r = rserve.serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=seed)
    key = jax.random.PRNGKey(seed)
    tree = _np_tree(rt.init_params(cfg, key))
    prompts = np.asarray(jax.random.randint(key, (batch, prompt_len), 0, cfg.vocab_size))
    run_t = tserve.serve(tcfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=seed,
                         device="cpu", params=tree, prompts=prompts)
    return run_r, run_t


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_equal_the_reference_float32(arch):
    """80 prompt tokens: the hybrid ring (64) wraps before the first decode
    step."""
    run_r, run_t = _serve_pair(arch, "float32", 2, 80, 6, 0)
    np.testing.assert_array_equal(run_t.tokens, run_r.tokens)
    assert run_t.cache_bytes == run_r.cache_bytes
    assert run_t.cache_bytes_raw_equiv == run_r.cache_bytes_raw_equiv
    assert (run_t.cache_bytes_raw_equiv == 0) == (arch == "mamba2-1.3b")


#: ROADMAP C5 for the ssm and hybrid families: the bf16 greedy tokens of
#: `serve()` against the reference's, 2 seeds x 4 requests x 16 generated,
#: 80-token prompts: mamba2-1.3b 117 of 128, recurrentgemma-9b 93 of 128
#: (measured on the CPU). A request that diverges stays
#: apart, each side feeding its own token. mamba2 runs no attention, so its
#: differences are the bf16 elementwise ops' rounding (XLA fuses them in
#: float32); recurrentgemma adds B10's float32 scores and p against the
#: reference's bf16 ones
BF16_TOKEN_AGREEMENT = {"mamba2-1.3b": 117 / 128, "recurrentgemma-9b": 93 / 128}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_bfloat16_agreement_rate(arch):
    equal = 0
    for seed in (0, 1):
        run_r, run_t = _serve_pair(arch, "bfloat16", 4, 80, 16, seed)
        equal += int((np.asarray(run_t.tokens) == np.asarray(run_r.tokens)).sum())
    rate = equal / (2 * 4 * 16)
    print(f"{arch} bfloat16 greedy tokens equal to the reference's: {equal} of {2 * 4 * 16} ({rate:.4f})")
    assert rate >= BF16_TOKEN_AGREEMENT[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_the_config_reduced(arch, capsys):
    import json

    tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "16", "--gen", "3"])
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == arch and len(out["sample_tokens"]) == 3
