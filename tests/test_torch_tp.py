"""Tensor parallelism over the model axis held to the reference's jitted,
sharded program on forced host devices.

The reference runs once for the file, in a subprocess with
`--xla_force_host_platform_device_count=4` and its meshes built with Auto
axes, as `tests/test_torch_mesh.py` builds them; its partitioner splits
the model axis's compute. The port runs its group programs here on a
`DeviceMesh` of four `cpu` slots, (data 1, model 4) and (data 2, model 2),
for four reduced configs in float32: qwen3-1.7b (dense), the same with 6
heads (1.5 heads a slot at model 4: the heads straddle the slots),
qwen3-moe-30b-a3b with 16 experts (expert parallelism: 16 divides the
production model axis), and mixtral-8x7b (d_ff split inside each expert;
its window widened to the 512-slot ring, which a 64-slot window could not
split 4 ways, in the reference as in the port).

Tolerances (float32), and why: the row-parallel sums (`psum`) add the
slots' partial products in another order than one device's product, and
XLA's partitioner orders its own, so the programs agree to float32
reduction order, not bit for bit:
  * prefill logits within 1e-4 absolute, decode logits within 2e-2, the
    ring's codes agreeing at >= 0.999 and the greedy tokens equal where the
    reference's top-2 margin exceeds twice the logits' tolerance:
    `test_torch_serve.py`'s tolerances and reasons (a code on a mu-law
    boundary moves by one; the decode reads a quantized ring);
  * loss and ce within 1e-5 relative, grad_norm 1e-4, and AdamW's first
    moment (the clipped gradient times 1 - b1) and the parameters after
    the step as `test_torch_mesh.py` holds the data-parallel step: mean
    absolute difference 1e-6, at most 0.1 % of a leaf's elements more than
    1e-5 apart.
The port's own unsharded program is held to the same tolerances: its
train step against the reference's sharded one on (data 1, model 4), where
the data axis does not split the moe capacity, and its serving against the
reference's unsharded serving (the sharded decode merges the slots'
statistics in another order than the single view: up to 2.2e-2 apart on
the logits here).
"""
import contextlib
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.configs import get_arch
from repro_torch.launch import steps
from repro_torch.models import partition
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_numpy, tree_to_named
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import sharding
from repro_torch.runtime.elastic import make_mesh, reshard

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

CPU = torch.device("cpu")
MAP2 = {"data": "data", "model": "model"}
MESHES = ((1, 4), (2, 2))
CONFIGS = {
    "dense": ("qwen3-1.7b", {}),
    "straddle": ("qwen3-1.7b", {"n_heads": 6}),
    "ep": ("qwen3-moe-30b-a3b", {"n_experts": 16}),
    "tp_expert": ("mixtral-8x7b", {"swa_window": 512}),
    "raw": ("qwen3-1.7b", {"kv_quant": False}),
}
#: the raw ring on (data 2, model 1): the decode fallbacks (no split of the
#: model axis; the ring read and written per data shard on its slot)
FALLBACK = ("raw", (2, 1))
PROMPT, GEN, CACHE = 300, 2, 512

_REF = r'''
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.launch import steps
from repro.models import partition
from repro.models.transformer import decode_step, init_params, prefill
from repro.optim import AdamWConfig
from repro.optim.adamw import AdamWState, adamw
from repro.runtime.sharding import param_specs, physical_specs, resolve

CONFIGS = %(configs)r
MESHES = %(meshes)r
FALLBACK = %(fallback)r
PROMPT, GEN, CACHE = %(serve)r
MAP2 = {"data": "data", "model": "model"}
out = {}

def flat(prefix, tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = np.asarray(leaf)

opt = AdamWConfig(lr=1e-3)
for tag, (arch, over) in CONFIGS.items():
    cfg = get_arch(arch).model.reduced(dtype="float32", **over)
    rng = np.random.default_rng(sum(map(ord, tag)))
    params = init_params(cfg, jax.random.PRNGKey(len(tag)))
    flat(tag + "/p0/", params)
    toks = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    stoks = rng.integers(0, cfg.vocab_size, (2, PROMPT + GEN)).astype(np.int32)
    out[tag + "/toks"], out[tag + "/stoks"] = toks, stoks
    for shape in MESHES + ((FALLBACK[1],) if tag == FALLBACK[0] else ()):
        m = "%%dx%%d" %% shape
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        with jax.set_mesh(mesh), partition.logical_axes(MAP2):
            if shape in MESHES:  # FALLBACK's mesh serves only: no test reads a train step there
                pl = param_specs(cfg, "train")
                pshard = resolve(pl, mesh)
                _, step = steps.make_train_step(cfg, opt, steps.TrainStepConfig(), mesh=mesh,
                                                param_pspecs=physical_specs(pl))
                oshard = AdamWState(step=NamedSharding(mesh, P()), m=pshard, v=pshard)
                bshard = {k: NamedSharding(mesh, P("data", None)) for k in ("inputs", "labels")}
                p = jax.tree_util.tree_map(jax.device_put, params, pshard)
                o = jax.tree_util.tree_map(jax.device_put, adamw(opt)[0](params), oshard)
                p, o, met = jax.jit(step, in_shardings=(pshard, oshard, bshard))(
                    p, o, {"inputs": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])})
                for k in ("loss", "ce", "grad_norm"):
                    out["%%s/%%s/train_%%s" %% (tag, m, k)] = np.asarray(met[k])
                flat("%%s/%%s/p/" %% (tag, m), p)
                flat("%%s/%%s/m/" %% (tag, m), o.m)
            cache, lg = jax.jit(lambda p, x: prefill(p, cfg, x, CACHE))(params, stoks[:, :PROMPT])
            out["%%s/%%s/prefill" %% (tag, m)] = np.asarray(lg)
            dec = jax.jit(lambda p, c, t: decode_step(p, cfg, c, t))
            for i in range(GEN):
                cache, lg = dec(params, cache, stoks[:, PROMPT + i:PROMPT + i + 1])
                out["%%s/%%s/decode_%%d" %% (tag, m, i)] = np.asarray(lg)
            out["%%s/%%s/kc" %% (tag, m)] = np.asarray(cache["layers"]["k_codes" if cfg.kv_quant else "k"])
    cache, lg = jax.jit(lambda p, x: prefill(p, cfg, x, CACHE))(params, stoks[:, :PROMPT])
    out[tag + "/single/prefill"] = np.asarray(lg)
    dec = jax.jit(lambda p, c, t: decode_step(p, cfg, c, t))
    for i in range(GEN):
        cache, lg = dec(params, cache, stoks[:, PROMPT + i:PROMPT + i + 1])
        out["%%s/single/decode_%%d" %% (tag, i)] = np.asarray(lg)
    out[tag + "/single/kc"] = np.asarray(cache["layers"]["k_codes" if cfg.kv_quant else "k"])
# the compressed pod sync under tensor parallelism: (pod 2, data 1, model 2)
from repro.core import gradient
MAP3 = {"data": ("pod", "data"), "model": "model"}
cfg = get_arch("qwen3-1.7b").model.reduced(dtype="float32")
params = init_params(cfg, jax.random.PRNGKey(7))
flat("comp/p0/", params)
toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
out["comp/toks"] = toks
mesh3 = jax.make_mesh((2, 1, 2), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
with jax.set_mesh(mesh3), partition.logical_axes(MAP3):
    pl = param_specs(cfg, "train")
    pshard = resolve(pl, mesh3)
    _, step = steps.make_train_step(cfg, opt, steps.TrainStepConfig(grad_compression=gradient.GradCompressionConfig()),
                                    mesh=mesh3, param_pspecs=physical_specs(pl))
    oshard = AdamWState(step=NamedSharding(mesh3, P()), m=pshard, v=pshard)
    bshard = {k: NamedSharding(mesh3, P(("pod", "data"), None)) for k in ("inputs", "labels")}
    p = jax.tree_util.tree_map(jax.device_put, params, pshard)
    o = jax.tree_util.tree_map(jax.device_put, adamw(opt)[0](params), oshard)
    p, o, met = jax.jit(step, in_shardings=(pshard, oshard, bshard))(
        p, o, {"inputs": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])})
    for k in ("loss", "ce", "grad_norm"):
        out["comp/train_" + k] = np.asarray(met[k])
flat("comp/p/", p)
flat("comp/m/", o.m)
np.savez(sys.argv[1], **out)
print("REF-TP-OK")
''' % {"configs": CONFIGS, "meshes": MESHES, "serve": (PROMPT, GEN, CACHE), "fallback": FALLBACK}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [os.path.join(os.path.dirname(__file__), "..", "src"), env.get("PYTHONPATH", "")] if p)
    proc = subprocess.run([sys.executable, "-c", _REF, str(path)], env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0 and "REF-TP-OK" in proc.stdout, proc.stdout + proc.stderr
    return dict(np.load(path))


def _cfg(tag):
    arch, over = CONFIGS[tag]
    return get_arch(arch).model.reduced(dtype="float32", **over)


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=[CPU] * int(np.prod(shape)))


def _tree(d, prefix):
    tree = {}
    for key, val in d.items():
        if key.startswith(prefix):
            node = tree
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = val
    return tree


def _assert_close(got: dict, want: dict):
    total, n = 0.0, 0
    for k, w in want.items():
        d = np.abs(got[k].numpy() - w)
        total, n = total + float(d.sum()), n + d.size
        far = float((d > 1e-5).mean())
        assert far <= 1e-3 and d.mean() <= 1e-6, (k, d.max(), d.mean(), far)
    assert total / n <= 1e-6


def _serve(cfg, model, toks, mesh):
    ctx = contextlib.ExitStack()
    if mesh is not None:
        ctx.enter_context(partition.logical_axes(MAP2))
        ctx.enter_context(partition.set_mesh(mesh))
    with torch.no_grad(), ctx:
        cache, lg = tt.prefill(model, cfg, toks[:, :PROMPT], CACHE)
        logits = [lg]
        toks_out = []
        for i in range(GEN):
            step_in = toks[:, PROMPT + i:PROMPT + i + 1]
            if mesh is not None:  # the greedy token over the split vocab beside the whole logits
                probe = {k: v for k, v in cache.items()}
                probe["layers"] = {k: sharding.Sharded([s.clone() for s in t.shards], t.placement, t.shape)
                                   for k, t in cache["layers"].items()}
                toks_out.append(tt.decode_greedy(model, cfg, probe, step_in)[1])
            cache, lg = tt.decode_step(model, cfg, cache, step_in)
            logits.append(lg)
    kc = cache["layers"]["k_codes" if cfg.kv_quant else "k"]
    return logits, (kc.gather() if isinstance(kc, sharding.Sharded) else kc), toks_out


@pytest.mark.parametrize("tag,shape", [(t, m) for t in CONFIGS for m in MESHES] + [FALLBACK],
                         ids=lambda v: v if isinstance(v, str) else "%dx%d" % v)
def test_split_serving_matches_the_reference(ref, tag, shape):
    """Prefill, decode and greedy tokens over the split program (and, for
    FALLBACK, the per-data-shard ring fallbacks)."""
    cfg = _cfg(tag)
    m = "%dx%d" % shape
    model = params_from_numpy(_tree(ref, tag + "/p0/"), cfg, "cpu")
    toks = torch.from_numpy(ref[tag + "/stoks"])
    mesh = _mesh(shape)
    with partition.logical_axes(MAP2), partition.set_mesh(mesh):
        assert tt.tp_active(cfg) == (shape[1] > 1)
    compat.reset_wire()
    runs = [("split", mesh)] + ([("unsharded", None)] if shape == (1, 4) else [])
    for what, msh in runs:
        logits, kc, greedy = _serve(cfg, model, toks, msh)
        m = "%dx%d" % shape if msh is not None else "single"  # the unsharded program against the reference's
        np.testing.assert_allclose(logits[0].numpy(), ref[f"{tag}/{m}/prefill"], rtol=0, atol=1e-4, err_msg=what)
        for i in range(GEN):
            want = ref[f"{tag}/{m}/decode_{i}"]
            np.testing.assert_allclose(logits[i + 1].numpy(), want, rtol=0, atol=2e-2, err_msg=what)
            if greedy:
                top2 = np.sort(want[:, 0], axis=-1)[:, -2:]
                clear = (top2[:, 1] - top2[:, 0]) > 4e-2
                got = greedy[i].numpy()[:, 0]
                assert (got == np.argmax(want[:, 0], -1))[clear].all(), what
                assert (got == torch.argmax(logits[i + 1], dim=-1).numpy()[:, 0]).all(), what
        if cfg.kv_quant:
            assert float((kc.numpy() == ref[f"{tag}/{m}/kc"]).mean()) >= 0.999, what
        else:
            np.testing.assert_allclose(kc.numpy(), ref[f"{tag}/{m}/kc"], rtol=0, atol=1e-4, err_msg=what)
    wire = compat.wire_bytes()
    assert wire["all_gather"] > 0 and (wire.get("psum", 0) > 0) == (shape[1] > 1)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("tag", list(CONFIGS))
def test_split_train_step_matches_the_reference(ref, tag, shape):
    cfg = _cfg(tag)
    m = "%dx%d" % shape
    p0 = {k: torch.from_numpy(np.array(v)) for k, v in tree_to_named(_tree(ref, tag + "/p0/")).items()}
    toks = torch.from_numpy(ref[tag + "/toks"])
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    runs = [("split", _mesh(shape))] + ([("unsharded", None)] if shape == (1, 4) else [])
    for what, mesh in runs:
        if mesh is None:
            init, step = steps.make_train_step(cfg, AdamWConfig(lr=1e-3), device="cpu")
            model, opt = init(0)
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(p0[k])
            model, opt, met = step(model, opt, batch)
            params = {k: p.detach() for k, p in model.named_parameters()}
            moments = opt.m
        else:
            with partition.logical_axes(MAP2):
                specs = sharding.param_specs(cfg, "train")
                init, step = steps.make_train_step(cfg, AdamWConfig(lr=1e-3), mesh=mesh,
                                                   param_pspecs=sharding.physical_specs(specs), device="cpu")
                _, opt = init(0)
            params, opt, met = step(reshard(p0, specs, mesh, MAP2), opt, batch)
            params, moments = sharding.gather(params), sharding.gather(opt.m)
            # each slot holds its own shard, and computed on its model shard
            assert len(opt.m["layers.0.attn.wq"].shards) == 4
        for k, tol in (("loss", 1e-5), ("ce", 1e-5), ("grad_norm", 1e-4)):
            np.testing.assert_allclose(float(met[k]), float(ref[f"{tag}/{m}/train_{k}"]), rtol=tol, err_msg=what)
        _assert_close(moments, tree_to_named(_tree(ref, f"{tag}/{m}/m/")))
        _assert_close(params, tree_to_named(_tree(ref, f"{tag}/{m}/p/")))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_collectives_are_differentiable_across_slots(n):
    """The backward of psum/pmax/all_gather over slots gives each slot's
    tensor what the same op on one device gives it."""
    gen = torch.Generator().manual_seed(n)
    xs = [torch.randn(3, 5, generator=gen, requires_grad=True) for _ in range(n)]
    w = torch.randn(3, 5, generator=gen)
    devs = [CPU] * n
    for op, one in ((compat.psum, lambda t: torch.stack(t).sum(0)), (compat.pmax, lambda t: torch.stack(t).amax(0)),
                    (lambda t, d: compat.all_gather(t, d, dim=1), lambda t: torch.cat(t, dim=1))):
        got = torch.autograd.grad(sum((y * (w if y.shape == w.shape else torch.cat([w] * n, 1))).sum()
                                      for y in op(xs, devs)[:1]), xs)
        ys = [x.detach().clone().requires_grad_() for x in xs]
        r = one(ys)
        want = torch.autograd.grad((r * (w if r.shape == w.shape else torch.cat([w] * n, 1))).sum(), ys)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("heads,n,straddle", [(16, 4, False), (6, 4, True), (24, 16, True), (56, 16, True),
                                               (32, 16, False)])
def test_head_splits_cover_every_head_once(heads, n, straddle):
    """Each q head is attended by one slot, each kv head contributed to the
    gathered K/V by one slot, and the slots' wq columns tile the width."""
    from repro_torch.models import layers

    cfg = dataclasses.replace(get_arch("qwen3-1.7b").model, n_heads=heads, n_kv_heads=8 if heads % 8 == 0 else 2)
    sp = layers.head_splits(cfg, n, kv_sharded=False)
    assert [s.heads for s in sp] == sorted(s.heads for s in sp) and sp[0].heads[0] == 0 and sp[-1].heads[1] == heads
    assert all(a.heads[1] == b.heads[0] for a, b in zip(sp, sp[1:]))
    assert sum(s.own_kv[1] - s.own_kv[0] for s in sp) == cfg.n_kv_heads
    assert [s.cols for s in sp] == [(i * heads * cfg.head_dim // n, (i + 1) * heads * cfg.head_dim // n)
                                    for i in range(n)]
    assert all(s.gather_q == straddle for s in sp)


def test_hint_checks_the_vocab_shard_in_a_group_program():
    mesh = _mesh((1, 4))
    with partition.logical_axes(MAP2), partition.set_mesh(mesh):
        g = partition.model_groups(mesh, {"model": (512, 4)})[0]
        assert g.map(lambda i: partition.hint(torch.zeros(2, 1, 128), "data", None, "model").shape[-1]) == [128] * 4
        with pytest.raises(ValueError, match="shard"):
            g.map(lambda i: partition.hint(torch.zeros(2, 1, 512), "data", None, "model"))


def test_split_train_step_with_the_compressed_pod_sync_matches_the_reference(ref):
    """(pod 2, data 1, model 2): the model shards gathered into whole
    leaves, synced over the pod axis once per data shard, and cut back.
    Tolerance as `test_torch_mesh.py` holds the compressed sync: a gradient
    within float32 noise of a mu-law code boundary lands one code apart,
    so every element within 5e-5 and the mean within 1e-6."""
    from repro_torch.core.gradient import GradCompressionConfig

    cfg = _cfg("dense")
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), devices=[CPU] * 4)
    mapping = {"data": ("pod", "data"), "model": "model"}
    p0 = {k: torch.from_numpy(np.array(v)) for k, v in tree_to_named(_tree(ref, "comp/p0/")).items()}
    toks = torch.from_numpy(ref["comp/toks"])
    with partition.logical_axes(mapping):
        specs = sharding.param_specs(cfg, "train")
        init, step = steps.make_train_step(cfg, AdamWConfig(lr=1e-3),
                                           steps.TrainStepConfig(grad_compression=GradCompressionConfig()),
                                           mesh=mesh, param_pspecs=sharding.physical_specs(specs), device="cpu")
        _, opt = init(0)
    compat.reset_wire()
    params, opt, met = step(reshard(p0, specs, mesh, mapping), opt, {"inputs": toks[:, :-1], "labels": toks[:, 1:]})
    assert compat.wire_bytes()["compressed"] > 0
    for k, tol in (("loss", 1e-5), ("ce", 1e-5), ("grad_norm", 1e-4)):
        np.testing.assert_allclose(float(met[k]), float(ref["comp/train_" + k]), rtol=tol)
    for got, prefix in ((sharding.gather(params), "comp/p/"), (sharding.gather(opt.m), "comp/m/")):
        want = tree_to_named(_tree(ref, prefix))
        total, n = 0.0, 0
        for k, w in want.items():
            d = np.abs(got[k].numpy() - w)
            total, n = total + float(d.sum()), n + d.size
            assert d.max() <= 5e-5, (k, d.max())
        assert total / n <= 1e-6


def test_split_prefill_longer_than_the_ring_matches_one_device():
    """A prompt of 700 positions into a 512-slot ring (a window of 512):
    each slot writes its slice of the wrapped ring, held to the port's
    unsharded prefill (the same quantizer on the same window: codes
    agreeing at >= 0.999, the scales within 1e-5 relative, logits within
    the serving tolerance)."""
    cfg = get_arch("qwen3-1.7b").model.reduced(dtype="float32", swa_window=512)
    model = tt.init_params(cfg, 3, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 700), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want_cache, want = tt.prefill(model, cfg, toks)
        with partition.logical_axes(MAP2), partition.set_mesh(_mesh((1, 4))):
            cache, got = tt.prefill(model, cfg, toks)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
    for name in ("k_codes", "v_codes"):
        a, b = cache["layers"][name].gather(), want_cache["layers"][name]
        assert a.shape == b.shape and float((a == b).double().mean()) >= 0.999, name
    for name in ("k_scale", "v_scale"):  # absmax of K/V that agree to float32 reduction order
        np.testing.assert_allclose(cache["layers"][name].gather().numpy(), want_cache["layers"][name].numpy(),
                                   rtol=1e-5, atol=0)
