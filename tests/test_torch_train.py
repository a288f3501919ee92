"""The port's training path (`repro_torch.models.layers.FlashAttention`,
`models.transformer.loss_fn`, `launch.steps.make_train_step`,
`launch.train.train`) against the reference's, in float32 on the same
numpy inputs at qwen3-1.7b's reduced width (2-3 layers, d_model 128), the
reference run under `jax.jit`.

Tolerances (float32), and why:
  * the flash backward (dq, dk, dv) against the reference's custom VJP:
    the reference's own test tolerance (`test_flash_custom_vjp_matches_
    naive_grads`: rtol 5e-3, atol 5e-4); measured ~1e-6: the same
    blockwise algorithm, the forward a dense softmax instead of the scan;
  * the log-sum-exp of B10's plain version against the reference's
    `_flash_scan`: 1e-5 absolute (float32 sums of the same exponentials in
    another order);
  * `loss_fn`: the loss within 1e-5 relative and every parameter's
    gradient within 1e-4 in relative norm (measured ~1.5e-6; matrix
    products over d_model 128 and the vocabulary sum in another order);
  * three `make_train_step` steps with 2 microbatches: losses and ce
    within 1e-5 relative, grad_norm 1e-4, lr 1e-6 (numpy's float32 cos
    against XLA's); the parameters: mean absolute difference 1e-6, and at
    most 0.1 % of a leaf's elements more than 1e-5 apart (an early AdamW
    step moves an element by ~lr * sign(g), so an element whose gradient
    is float32 noise can move the other way by ~2 lr: measured 2.9e-4 on
    one element of the embedding at lr 1e-2).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as rget
from repro.launch import steps as rsteps
from repro.launch import train as rtrain
from repro.models import layers as rl
from repro.models import transformer as rt
from repro.optim import AdamWConfig as RAdamWConfig
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.convert import named_to_tree, params_from_numpy, params_to_numpy, tree_to_named
from repro_torch.optim import AdamWConfig

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

KEY = jax.random.PRNGKey(0)


def _cfgs(**kw):
    kw.setdefault("dtype", "float32")
    return rget("qwen3-1.7b").model.reduced(**kw), get_arch("qwen3-1.7b").model.reduced(**kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ref_grads_tree(g):
    return jax.tree_util.tree_map(np.asarray, g)


def _tree_rel(port: dict, refr: dict) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(refr)[0]:
        node = port
        for k in path:
            node = node[k.key]
        out["/".join(k.key for k in path)] = _rel(node, leaf)
    return out


# ------------------------------------------------------------- attention --
@pytest.mark.parametrize("window", [None, 24, 5])
@pytest.mark.parametrize("kv_block", [16, 1024])
def test_flash_backward_matches_reference_custom_vjp(window, kv_block):
    """dq, dk, dv of the port's FlashAttention against the reference's
    `flash_attention` custom VJP, causal and windowed, at the reference
    test's shapes."""
    b, s, h, kh, dh = 2, 48, 4, 2, 16
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for shape in ((b, s, h, dh), (b, s, kh, dh), (b, s, kh, dh)))
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    want = jax.jit(jax.grad(lambda *a: jnp.sum(rl.flash_attention(*a, pos, pos, window=window, kv_block=16) ** 2),
                            (0, 1, 2)))(q, k, v)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = tl.FlashAttention.apply(tq, tk, tv, window, True)
    if kv_block != tl.KV_BLOCK:
        dq, dk, dv = tl.flash_backward(tq.detach(), tk.detach(), tv.detach(), out.detach(),
                                       ops.flash_attention_fwd_lse(tq.detach(), tk.detach(), tv.detach(),
                                                                   window=window)[1],
                                       2 * out.detach(), window, True, kv_block=kv_block)
    else:
        torch.sum(out ** 2).backward()
        dq, dk, dv = tq.grad, tk.grad, tv.grad
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("window", [None, 7])
def test_lse_matches_reference_flash_scan(window):
    """The plain version's log-sum-exp (`ops.flash_attention_fwd_lse` on the
    CPU) against the reference's `_flash_scan` lse, GQA, ragged against
    the scan's blocks."""
    b, s, h, kh, dh = 2, 37, 4, 2, 16
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for shape in ((b, s, h, dh), (b, s, kh, dh), (b, s, kh, dh)))
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    c = 8
    pad = (-s) % c
    kp = jnp.pad(k, ((0, 0), (0, pad), (0, 0), (0, 0)))
    vp = jnp.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
    kvpos = jnp.pad(pos, ((0, 0), (0, pad)), constant_values=-1)
    valid = jnp.pad(jnp.ones((b, s), bool), ((0, 0), (0, pad)), constant_values=False)
    out_r, lse_r = jax.jit(lambda *a: rl._flash_scan(*a, pos, kvpos, valid, window, True, c))(q, kp, vp)
    out, lse = ops.flash_attention_fwd_lse(_t(q), _t(k), _t(v), window=window)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r).reshape(b, h, s), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.moveaxis(np.asarray(out_r).reshape(b, h, s, dh), 1, 2),
                               atol=1e-5, rtol=1e-5)


def test_lse_form_out_equals_plain_form():
    rng = np.random.default_rng(4)
    q, k, v = (_t(rng.normal(size=shape).astype(np.float32)) for shape in ((1, 20, 4, 8), (1, 20, 1, 8), (1, 20, 1, 8)))
    out, lse = ops.flash_attention_fwd_lse(q, k, v, window=6)
    assert torch.equal(out, ref.flash_reference(q, k, v, window=6))
    assert lse.shape == (1, 4, 20) and lse.dtype == torch.float32


def test_lse_form_counts_no_cpu_launch():
    before = ops.launch_counts()
    q = torch.zeros((1, 4, 2, 8))
    ops.flash_attention_fwd_lse(q, q[:, :, :1].contiguous(), q[:, :, :1].contiguous())
    ops.flash_attention_fwd_lse_fma(q, q[:, :, :1].contiguous(), q[:, :, :1].contiguous())
    assert ops.launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lse_fma_form_equals_the_lse_form_on_the_cpu(dtype):
    """On CPU tensors both lse wrappers are the plain version."""
    rng = np.random.default_rng(6)
    q, k, v = (_t(rng.normal(size=shape).astype(np.float32)).to(dtype)
               for shape in ((1, 20, 4, 16), (1, 20, 2, 16), (1, 20, 2, 16)))
    out, lse = ops.flash_attention_fwd_lse_fma(q, k, v, window=5)
    want_out, want_lse = ops.flash_attention_fwd_lse(q, k, v, window=5)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)


# ------------------------------------------------------------ the model --
@pytest.fixture(scope="module")
def pair():
    cfg, tcfg = _cfgs(n_layers=2)
    params = rt.init_params(cfg, KEY)
    tree = jax.tree_util.tree_map(np.asarray, params)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 25)).astype(np.int32)
    return cfg, tcfg, params, tree, toks


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match_reference(pair, remat, masked):
    cfg, tcfg, params, tree, toks = pair
    cfg, tcfg = dataclasses.replace(cfg, remat=remat), dataclasses.replace(tcfg, remat=remat)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    if masked:
        batch["mask"] = (np.arange(24)[None] % 3 != 0).astype(np.float32).repeat(2, 0)
    (loss, m), g = jax.jit(jax.value_and_grad(lambda p, b: rt.loss_fn(p, cfg, b), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = params_from_numpy(tree, tcfg, "cpu", param_dtype="float32")
    tloss, tm = tt.loss_fn(model, tcfg, {k: _t(v) for k, v in batch.items()})
    tloss.backward()
    assert abs(tloss.item() - float(loss)) <= 1e-5 * abs(float(loss))
    assert abs(tm["ce"].item() - float(m["ce"])) <= 1e-5 * abs(float(m["ce"]))
    assert tm["aux"].item() == float(m["aux"]) == 0.0
    rel = _tree_rel(named_to_tree({k: p.grad.numpy() for k, p in model.named_parameters()}), _ref_grads_tree(g))
    assert max(rel.values()) < 1e-4, rel


def test_forward_runs_b10_lse_form_once_per_layer_and_recompute(pair, monkeypatch):
    """With remat full, each block's forward runs again in the backward:
    the lse form is called twice per layer per step."""
    _, tcfg, _, tree, toks = pair
    tcfg = dataclasses.replace(tcfg, remat="full")
    calls = []
    orig = ops.flash_attention_fwd_lse
    monkeypatch.setattr(ops, "flash_attention_fwd_lse", lambda *a, **k: calls.append(1) or orig(*a, **k))
    model = params_from_numpy(tree, tcfg, "cpu", param_dtype="float32")
    loss, _ = tt.loss_fn(model, tcfg, {"inputs": _t(toks[:, :-1]), "labels": _t(toks[:, 1:])})
    assert len(calls) == tcfg.n_layers
    loss.backward()
    assert len(calls) == 2 * tcfg.n_layers


def test_training_storage_is_float32_masters_with_grads(pair):
    _, tcfg, _, tree, _ = pair
    bf = dataclasses.replace(tcfg, dtype="bfloat16")
    train = params_from_numpy(tree, bf, "cpu", param_dtype="float32")
    serve = params_from_numpy(tree, bf, "cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad for p in train.parameters())
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in serve.parameters())
    assert train.layers[0].attn.params()["wq"].dtype == torch.bfloat16
    toks = torch.zeros((1, 5), dtype=torch.int32)
    with torch.no_grad():
        a, _ = tt.forward(train, bf, toks)
        b, _ = tt.forward(serve, bf, toks)
    assert torch.equal(a, b)  # masters cast at every use compute what bf16 storage does


def test_params_numpy_roundtrip_through_masters(pair):
    _, tcfg, _, tree, _ = pair
    model = params_from_numpy(tree, tcfg, "cpu", param_dtype="float32")
    back = params_to_numpy(model)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)
    named = tree_to_named(back)
    assert set(named) == {k for k, _ in model.named_parameters()}


def test_softcap_refused_in_training():
    """A logit softcap is no longer refused in training: a capped model
    with float32 masters and full remat matches the reference's loss and
    gradients (its `_flash_ad` path) within the tolerances of
    `test_loss_and_grads_match_reference`; `tests/test_torch_softcap.py`
    holds the cap itself tighter."""
    cfg, tcfg = _cfgs(n_layers=2, attn_logit_softcap=2.0, remat="full")
    params = rt.init_params(cfg, KEY)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 25)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    (loss, _), g = jax.jit(jax.value_and_grad(lambda p, b: rt.loss_fn(p, cfg, b), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu", param_dtype="float32")
    tloss, _ = tt.loss_fn(model, tcfg, {k: _t(v) for k, v in batch.items()})
    tloss.backward()
    assert abs(tloss.item() - float(loss)) <= 1e-5 * abs(float(loss))
    rel = _tree_rel(named_to_tree({k: p.grad.numpy() for k, p in model.named_parameters()}), _ref_grads_tree(g))
    assert max(rel.values()) < 1e-4, rel


# ------------------------------------------------------------ train step --
def test_make_train_step_three_steps_match_reference(pair):
    cfg, tcfg, params, tree, _ = pair
    mb = 2
    rng = np.random.default_rng(9)
    batches = [rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32) for _ in range(3)]
    opt = dict(lr=1e-2, weight_decay=0.1)
    from repro.optim.schedules import warmup_cosine as rwc
    from repro_torch.optim.schedules import warmup_cosine as twc

    r_init, r_step = rsteps.make_train_step(cfg, RAdamWConfig(schedule=rwc(1, 3), **opt),
                                            rsteps.TrainStepConfig(microbatches=mb))
    r_step = jax.jit(r_step)
    t_init, t_step = tsteps.make_train_step(tcfg, AdamWConfig(schedule=twc(1, 3), **opt),
                                            tsteps.TrainStepConfig(microbatches=mb), device="cpu")
    from repro.optim import adamw as radamw
    from repro_torch.optim import adamw as tadamw

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
        assert abs(tm["lr"] - float(rm["lr"])) <= 1e-6 * float(rm["lr"])
    assert int(t_opt.step) == int(r_opt.step) == 3
    got = params_to_numpy(model)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, r_params))[0]:
        node = got
        for k in path:
            node = node[k.key]
        d = np.abs(node - leaf)
        far = float((d > 1e-5).mean())
        assert far <= 1e-3 and d.mean() <= 1e-6, ("/".join(k.key for k in path), d.max(), d.mean(), far)


def test_microbatch_split_and_pick_microbatches():
    x = torch.arange(24).reshape(6, 4)
    got = tsteps.microbatch_split({"inputs": x}, 3)["inputs"]
    want = rsteps.microbatch_split({"inputs": jnp.asarray(x.numpy())}, 3)["inputs"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tsteps.microbatch_split({"inputs": x}, 1)["inputs"] is x
    for arch in ("qwen3-1.7b",):
        for gb, seq, ds in ((256, 4096, 16), (8, 128, 1), (64, 2048, 4)):
            assert tsteps.pick_microbatches(get_arch(arch).model, gb, seq, ds) == \
                rsteps.pick_microbatches(rget(arch).model, gb, seq, ds)


def test_param_pspecs_refused_naming_a10(pair):
    """`param_pspecs=` is no longer refused (the name is kept from when it
    was): masters and AdamW moments held as shards on a (pod 2, data 2,
    model 1) mesh of CPU slots, each slot's program on its rows of the
    batch, two microbatches, three steps, held to the reference's
    unsharded jitted step within the tolerances of
    `test_make_train_step_three_steps_match_reference`, but for one: at
    most 0.5 % of a leaf's elements more than 1e-5 apart, not 0.1 %. The
    sharded program's numbers are the unsharded one's up to reduction
    order, and here the four slots sum their own rows' gradients before
    the merge adds the four sums, so an element whose gradient is float32
    noise takes the other sign (and AdamW's ~lr step the other way) more
    often: measured 0.21 % of the embedding at lr 1e-2 after three steps.
    `tests/test_torch_mesh.py` holds the step to the reference's sharded
    step."""
    from repro_torch.models import partition
    from repro_torch.runtime import sharding
    from repro_torch.runtime.elastic import make_mesh, reshard

    cfg, tcfg, params, tree, _ = pair
    mb, opt = 2, dict(lr=1e-2, weight_decay=0.1)
    rng = np.random.default_rng(9)
    batches = [rng.integers(0, cfg.vocab_size, (8, 17)).astype(np.int32) for _ in range(3)]
    r_init, r_step = rsteps.make_train_step(cfg, RAdamWConfig(**opt), rsteps.TrainStepConfig(microbatches=mb))
    r_step = jax.jit(r_step)
    from repro.optim import adamw as radamw

    r_params, r_opt = params, radamw(RAdamWConfig(**opt))[0](params)
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), devices=["cpu"] * 4)
    mapping = {"data": ("pod", "data"), "model": "model"}
    with partition.logical_axes(mapping):
        specs = sharding.param_specs(tcfg, "train")
        t_init, t_step = tsteps.make_train_step(tcfg, AdamWConfig(**opt), tsteps.TrainStepConfig(microbatches=mb),
                                                mesh=mesh, param_pspecs=sharding.physical_specs(specs), device="cpu")
        _, t_opt = t_init(0)
    t_params = reshard({k: _t(v) for k, v in tree_to_named(tree).items()}, specs, mesh, mapping)
    for toks in batches:
        rb = rsteps.microbatch_split({"inputs": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}, mb)
        tb = tsteps.microbatch_split({"inputs": _t(toks[:, :-1]), "labels": _t(toks[:, 1:])}, mb)
        r_params, r_opt, rm = r_step(r_params, r_opt, rb)
        t_params, t_opt, tm = t_step(t_params, t_opt, tb)
        for k in ("loss", "ce"):
            assert abs(float(tm[k]) - float(rm[k])) <= 1e-5 * abs(float(rm[k])), k
        assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= 1e-4 * float(rm["grad_norm"])
    assert int(t_opt.step) == 3
    got = named_to_tree({k: v.numpy() for k, v in sharding.gather(t_params).items()})
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, r_params))[0]:
        node = got
        for k in path:
            node = node[k.key]
        d = np.abs(node - leaf)
        far = float((d > 1e-5).mean())
        assert far <= 5e-3 and d.mean() <= 1e-6, ("/".join(k.key for k in path), d.max(), d.mean(), far)


def test_train_step_with_compressed_sync_on_a_one_slot_mesh():
    from repro_torch.core.gradient import GradCompressionConfig
    from repro_torch.runtime.elastic import make_mesh

    _, tcfg = _cfgs(n_layers=1)
    mesh = make_mesh((1,), ("pod",), device="cpu")
    step_cfg = tsteps.TrainStepConfig(grad_compression=GradCompressionConfig(qbits=8))
    init, step = tsteps.make_train_step(tcfg, AdamWConfig(), step_cfg, mesh=mesh, device="cpu")
    model, opt = init(0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 9)).astype(np.int32))
    model, opt, m = step(model, opt, {"inputs": toks[:, :-1], "labels": toks[:, 1:]})
    assert np.isfinite(float(m["loss"])) and int(opt.step) == 1


@pytest.mark.parametrize("shape,names", [((2,), ("pod",)), ((2, 2), ("pod", "data"))])
def test_train_step_refuses_a_sync_axis_of_several_slots(shape, names):
    """A compressed sync over an axis of several slots is no longer refused
    (the name is kept from when it was): one model per slot, the
    gradients' global mean on every slot, then the pod sync. Every pod
    then holds the same mean, so the sync is one quantize round trip, as
    on the reference's one-device mesh, held here in float32: loss and ce
    within 1e-5 relative, grad_norm 1e-4, every parameter within 5e-5 and
    their mean difference within 1e-6 (a gradient within float32 noise of a
    mu-law code boundary lands one code apart; `tests/test_torch_mesh.py`
    states the same)."""
    from jax.sharding import AxisType

    from repro.core.gradient import GradCompressionConfig as RGC
    from repro.optim import adamw as radamw
    from repro_torch.core.gradient import GradCompressionConfig
    from repro_torch.runtime import sharding
    from repro_torch.runtime.elastic import make_mesh

    cfg, tcfg = _cfgs(n_layers=1)
    params = rt.init_params(cfg, KEY)
    tree = jax.tree_util.tree_map(np.asarray, params)
    toks = np.random.default_rng(1).integers(0, 512, (4, 9)).astype(np.int32)
    opt = dict(lr=1e-3)
    rmesh = jax.make_mesh((1,) * len(shape), names, axis_types=(AxisType.Auto,) * len(shape))
    _, r_step = rsteps.make_train_step(cfg, RAdamWConfig(**opt), rsteps.TrainStepConfig(grad_compression=RGC()),
                                       mesh=rmesh)
    with jax.set_mesh(rmesh):
        r_params, _, rm = jax.jit(r_step)(params, radamw(RAdamWConfig(**opt))[0](params),
                                          {"inputs": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])})
    mesh = make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))
    step_cfg = tsteps.TrainStepConfig(grad_compression=GradCompressionConfig())
    init, step = tsteps.make_train_step(tcfg, AdamWConfig(**opt), step_cfg, mesh=mesh, device="cpu")
    _, opt_state = init(0)
    t_params = {k: sharding.Placement(mesh, ()).place(_t(v)) for k, v in tree_to_named(tree).items()}
    t_params, opt_state, tm = step(t_params, opt_state, {"inputs": _t(toks[:, :-1]), "labels": _t(toks[:, 1:])})
    for k, tol in (("loss", 1e-5), ("ce", 1e-5), ("grad_norm", 1e-4)):
        assert abs(float(tm[k]) - float(rm[k])) <= tol * abs(float(rm[k])), k
    got = tree_to_named(named_to_tree({k: v.numpy() for k, v in sharding.gather(t_params).items()}))
    want = tree_to_named(jax.tree_util.tree_map(np.asarray, r_params))
    diffs = [np.abs(got[k] - w) for k, w in want.items()]
    assert max(float(d.max()) for d in diffs) <= 5e-5
    assert sum(float(d.sum()) for d in diffs) / sum(d.size for d in diffs) <= 1e-6
    assert int(opt_state.step) == 1


def test_train_step_without_compression_ignores_the_mesh():
    """Without a compression config the reference's step takes no sync
    branch, whatever the mesh: neither does the port's."""
    from repro_torch.runtime.elastic import make_mesh

    _, tcfg = _cfgs(n_layers=1)
    mesh = make_mesh((2,), ("pod",), devices=["cpu"] * 2)
    init, step = tsteps.make_train_step(tcfg, AdamWConfig(), mesh=mesh, device="cpu")
    model, opt = init(0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 9)).astype(np.int32))
    _, opt, m = step(model, opt, {"inputs": toks[:, :-1], "labels": toks[:, 1:]})
    assert np.isfinite(float(m["loss"])) and int(opt.step) == 1


# ---------------------------------------------------------------- train() --
@pytest.mark.parametrize("every,fail_at", [(4, (6,)), (3, (2, 7)), (5, (3,))])
def test_train_restarts_like_the_reference(tmp_path, every, fail_at, capsys):
    """An injected fault restarts from the latest checkpoint: the port's
    restarts, resume steps and final step equal the reference's."""
    cfg, tcfg = _cfgs(dtype="bfloat16")
    kw = dict(steps=10, batch=2, seq=16, checkpoint_every=every, fail_at=fail_at, log_every=1)
    want = rtrain.train(cfg, checkpoint_dir=str(tmp_path / "r"), **kw)
    rlog = capsys.readouterr().out
    got = ttrain.train(tcfg, checkpoint_dir=str(tmp_path / "t"), device="cpu", **kw)
    tlog = capsys.readouterr().out
    assert (got.restarts, got.final_step, got.stragglers >= 0) == (want.restarts, want.final_step, True)
    resumed = lambda log: [ln.split("resumed at step ")[1] for ln in log.splitlines() if "resumed at" in ln]
    assert resumed(tlog) == resumed(rlog)
    assert len(got.losses) == len(want.losses) and all(np.isfinite(got.losses))
    assert got.feed_ratio > 1.0


def test_train_resumes_from_the_references_checkpoint(tmp_path):
    """A run of the reference's trainer leaves a checkpoint the port's
    trainer resumes from (`--resume`), at the reference's step."""
    cfg, tcfg = _cfgs()
    rtrain.train(cfg, steps=4, batch=2, seq=16, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    got = ttrain.train(tcfg, steps=6, batch=2, seq=16, checkpoint_dir=str(tmp_path), resume=True,
                       device="cpu")
    assert got.final_step == 6 and len(got.losses) == 2


def test_train_main_prints_the_reference_keys(capsys):
    ttrain.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "8"])
    out = json.loads(capsys.readouterr().out.split("\n", 1)[1])
    assert set(out) == {"arch", "final_loss", "first_loss", "tokens_per_s", "feed_compression_ratio",
                        "restarts", "stragglers", "final_step"}
    assert out["final_step"] == 2
