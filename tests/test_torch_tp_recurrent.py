"""Tensor parallelism over the model axis for the ssm and hybrid families
held to the reference's jitted, sharded program on forced host devices.

The reference runs once for the file, in a subprocess with
`--xla_force_host_platform_device_count=4` and its meshes built with Auto
axes, as `tests/test_torch_tp.py` runs it; its partitioner splits the
model axis's compute. The port runs its group programs here on a
`DeviceMesh` of four `cpu` slots, (data 1, model 4) and (data 2, model 2),
for two reduced configs in float32: mamba2-1.3b (8 SSD heads and 320 conv
channels: at model 4 a slot's 80 channels straddle 2.5 heads, as its 1,088
straddle 17 at full width) and recurrentgemma-9b with its window widened to
the 512-slot ring (a 64-slot window's one scale group cannot split 4 ways,
in the reference's `shard_map` as in the port).

Tolerances (float32), and why: the row-parallel sums (`psum`) add the
slots' partial products in another order than one device's product, and
XLA's partitioner orders its own, so the programs agree to float32
reduction order, not bit for bit. Serving: prefill logits and every
recurrent state shard, gathered, within 1e-4 absolute, ring codes agreeing
at >= 0.999, decode logits within 2e-2, greedy tokens equal where the
reference's top-2 margin exceeds twice the logits' tolerance
(`test_torch_tp.py`'s and `test_torch_recurrent.py`'s tolerances and
reasons). After the decode steps the ssm's states are held within 1e-4
again; the hybrid's lie behind the decode's attention over the quantized
ring and are held within 5e-3: on this config the reference's own sharded
and unsharded decodes put its tail's conv tail 1.7e-3 apart after one step
(the port's unsharded decode 5.0e-4 from the reference's unsharded one, and
its split decode 3.5e-4 from the reference's split one, on (1, 4)).
The train step: loss and ce within 1e-5 relative, grad_norm 1e-4, and
AdamW's first moment and the parameters after the step with a mean
absolute difference of 1e-6 and at most 0.1 % of a leaf's elements more
than 1e-5 apart, one element allowed in a leaf of fewer than 1,000
(`test_torch_recurrent.py`'s allowance: AdamW's first step divides a
near-zero gradient by its own root).

The group forms of the blocks (`ssd.mamba2_group`, `rglru.rglru_group`)
are held on n = 1, 2, 4 slots to the port's whole-weight forms within
2e-5 (`test_torch_recurrent.py`'s block tolerance).
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
from repro_torch.models import partition, rglru, ssd
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
    "ssm": ("mamba2-1.3b", {}),
    "hybrid": ("recurrentgemma-9b", {"local_window": 512}),
}
PROMPT, GEN, CACHE = 300, 2, 600

_REF = r'''
import os, sys
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
    for shape in MESHES:
        m = "%%dx%%d" %% shape
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        with jax.set_mesh(mesh), partition.logical_axes(MAP2):
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
            flat("%%s/%%s/cache0/" %% (tag, m), {k: v for k, v in cache.items() if k != "pos"})
            dec = jax.jit(lambda p, c, t: decode_step(p, cfg, c, t))
            for i in range(GEN):
                cache, lg = dec(params, cache, stoks[:, PROMPT + i:PROMPT + i + 1])
                out["%%s/%%s/decode_%%d" %% (tag, m, i)] = np.asarray(lg)
            flat("%%s/%%s/cache/" %% (tag, m), {k: v for k, v in cache.items() if k != "pos"})
np.savez(sys.argv[1], **out)
print("REF-TP-RECURRENT-OK")
''' % {"configs": CONFIGS, "meshes": MESHES, "serve": (PROMPT, GEN, CACHE)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp_recurrent") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [os.path.join(os.path.dirname(__file__), "..", "src"), env.get("PYTHONPATH", "")] if p)
    proc = subprocess.run([sys.executable, "-c", _REF, str(path)], env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0 and "REF-TP-RECURRENT-OK" in proc.stdout, proc.stdout + proc.stderr
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


def _leaves(cache, prefix=""):
    """{"groups/rec1/h": whole tensor, ...} of a cache without `pos`."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        elif k != "pos":
            out[prefix + k] = v.gather() if isinstance(v, sharding.Sharded) else v
    return out


def _check_cache(got: dict, ref: dict, prefix: str, atol: float = 1e-4):
    """Every state gathered within `atol`, ring codes at >= 0.999, ring
    scales within 1e-5 relative (absmax of K/V that agree to reduction
    order)."""
    want = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, w in want.items():
        a = got[k].numpy()
        assert a.shape == w.shape, (k, a.shape, w.shape)
        if a.dtype == np.uint8:
            assert float((a == w).mean()) >= 0.999, k
        elif k.endswith("_scale"):
            np.testing.assert_allclose(a, w, rtol=1e-5, atol=0, err_msg=k)
        else:
            np.testing.assert_allclose(a, w, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("tag,shape", [(t, m) for t in CONFIGS for m in MESHES],
                         ids=lambda v: v if isinstance(v, str) else "%dx%d" % v)
def test_split_serving_matches_the_reference(ref, tag, shape):
    """Prefill logits and states, decode logits, states and greedy tokens of
    the split program; every state leaf held as model shards."""
    cfg = _cfg(tag)
    m = "%dx%d" % shape
    model = params_from_numpy(_tree(ref, tag + "/p0/"), cfg, "cpu")
    toks = torch.from_numpy(ref[tag + "/stoks"])
    mesh = _mesh(shape)
    compat.reset_wire()
    with torch.no_grad(), partition.logical_axes(MAP2), partition.set_mesh(mesh):
        assert tt.tp_active(cfg)
        cache, lg = tt.prefill(model, cfg, toks[:, :PROMPT], CACHE)
        np.testing.assert_allclose(lg.numpy(), ref[f"{tag}/{m}/prefill"], rtol=0, atol=1e-4)
        _check_cache(_leaves(cache), ref, f"{tag}/{m}/cache0/")
        for i in range(GEN):
            step_in = toks[:, PROMPT + i:PROMPT + i + 1]
            probe = sharding.tree_map(lambda t: sharding.Sharded([s.clone() for s in t.shards], t.placement, t.shape)
                                      if isinstance(t, sharding.Sharded) else t, cache,
                                      is_leaf=lambda t: isinstance(t, sharding.Sharded))
            greedy = tt.decode_greedy(model, cfg, probe, step_in)[1].numpy()[:, 0]
            cache, lg = tt.decode_step(model, cfg, cache, step_in)
            want = ref[f"{tag}/{m}/decode_{i}"]
            np.testing.assert_allclose(lg.numpy(), want, rtol=0, atol=2e-2)
            top2 = np.sort(want[:, 0], axis=-1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > 4e-2
            assert (greedy == np.argmax(want[:, 0], -1))[clear].all()
            assert (greedy == torch.argmax(lg, dim=-1).numpy()[:, 0]).all()
    for k, t in _leaves(cache).items():
        assert t.shape == ref[f"{tag}/{m}/cache/{k}"].shape, k
    _check_cache(_leaves(cache), ref, f"{tag}/{m}/cache/", 1e-4 if tag == "ssm" else 5e-3)
    leaf = cache["layers"]["ssm_state"] if tag == "ssm" else cache["groups"]["rec1"]["h"]
    assert len(leaf.shards) == 4 and leaf.shards[0].shape[-1 if tag == "hybrid" else 3] * shape[1] == \
        leaf.shape[-1 if tag == "hybrid" else 3]
    wire = compat.wire_bytes()
    assert wire["all_gather"] > 0 and wire["psum"] > 0


def _assert_close(got: dict, want: dict):
    total, n = 0.0, 0
    for k, w in want.items():
        d = np.abs(got[k].numpy() - w)
        total, n = total + float(d.sum()), n + d.size
        far = float((d > 1e-5).mean())
        allowed = 1.0 / d.size if d.size < 1000 else 1e-3
        assert far <= max(1e-3, allowed) and d.mean() <= 1e-6, (k, d.max(), d.mean(), far)
    assert total / n <= 1e-6


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("tag", list(CONFIGS))
def test_split_train_step_matches_the_reference(ref, tag, shape):
    cfg = _cfg(tag)
    m = "%dx%d" % shape
    p0 = {k: torch.from_numpy(np.array(v)) for k, v in tree_to_named(_tree(ref, tag + "/p0/")).items()}
    toks = torch.from_numpy(ref[tag + "/toks"])
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    mesh = _mesh(shape)
    with partition.logical_axes(MAP2):
        specs = sharding.param_specs(cfg, "train")
        init, step = steps.make_train_step(cfg, AdamWConfig(lr=1e-3), mesh=mesh,
                                           param_pspecs=sharding.physical_specs(specs), device="cpu")
        _, opt = init(0)
    compat.reset_wire()
    params, opt, met = step(reshard(p0, specs, mesh, MAP2), opt, batch)
    assert compat.wire_bytes()["psum"] > 0
    split = "layers.0.mixer.in_proj" if tag == "ssm" else "groups.0.rec1.rglru.w_a"
    assert opt.m[split].shards[0].shape[1] * shape[1] == opt.m[split].shape[1]
    for k, tol in (("loss", 1e-5), ("ce", 1e-5), ("grad_norm", 1e-4)):
        np.testing.assert_allclose(float(met[k]), float(ref[f"{tag}/{m}/train_{k}"]), rtol=tol)
    _assert_close(sharding.gather(opt.m), tree_to_named(_tree(ref, f"{tag}/{m}/m/")))
    _assert_close(sharding.gather(params), tree_to_named(_tree(ref, f"{tag}/{m}/p/")))


def _group(n):
    mesh = _mesh((1, n))
    with partition.logical_axes(MAP2), partition.set_mesh(mesh):
        return partition.model_groups(mesh, {})[0]


def _slot_params(named, cfg, prefix, n):
    """Each slot's nested parameters of block `prefix` of a whole model."""
    ms = sharding.model_split(cfg)
    return [tt.nested({k[len(prefix):]: sharding.slot_weight(p.detach(), ms[k], i, n, CPU)
                       for k, p in named.items() if k.startswith(prefix)}) for i in range(n)]


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("decode", [False, True])
def test_mamba2_group_matches_the_whole_block(n, decode):
    cfg = _cfg("ssm")
    model = tt.init_params(cfg, 2, "cpu")
    named = dict(model.named_parameters())
    gen = torch.Generator().manual_seed(n)
    s = 1 if decode else 45  # a ragged last chunk
    x = torch.randn(2, s, cfg.d_model, generator=gen)
    h0 = torch.randn(2, 1, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, generator=gen) * 0.1
    tail = torch.randn(2, cfg.conv_width - 1, ssd.conv_dim(cfg), generator=gen)
    p = model.layers[0].mixer.params()
    with torch.no_grad():
        fn = ssd.mamba2_decode if decode else ssd.mamba2_apply
        y, h, t = fn(p, cfg, x, h0, tail)
        g = _group(n)
        ps = [q for q in _slot_params(named, cfg, "layers.0.mixer.", n)]
        hs, ts = list(h0.chunk(n, dim=2)), list(tail.chunk(n, dim=-1))
        ys, hg, tg = ssd.mamba2_group(g, ps, cfg, [x] * n, hs, ts, decode=decode)
    for yi in ys:
        np.testing.assert_allclose(yi.numpy(), y.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(torch.cat(hg, dim=2).numpy(), h.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(torch.cat(tg, dim=-1).numpy(), t.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("s", [1, 37])
def test_rglru_group_matches_the_whole_block(n, s):
    cfg = _cfg("hybrid")
    model = tt.init_params(cfg, 2, "cpu")
    named = dict(model.named_parameters())
    gen = torch.Generator().manual_seed(n + s)
    x = torch.randn(2, s, cfg.d_model, generator=gen)
    h0 = torch.randn(2, cfg.lru_width, generator=gen)
    tail = torch.randn(2, cfg.conv_width - 1, cfg.lru_width, generator=gen)
    with torch.no_grad():
        y, h, t = rglru.rglru_apply(model.groups[0].rec1.rglru.params(), x, h0, tail)
        ps = _slot_params(named, cfg, "groups.0.rec1.rglru.", n)
        ys, hg, tg = rglru.rglru_group(_group(n), ps, [x] * n, list(h0.chunk(n, dim=-1)),
                                       list(tail.chunk(n, dim=-1)))
    for yi in ys:
        np.testing.assert_allclose(yi.numpy(), y.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(torch.cat(hg, dim=-1).numpy(), h.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(torch.cat(tg, dim=-1).numpy(), t.numpy(), rtol=0, atol=2e-5)


def test_split_hybrid_prefill_longer_than_the_ring_matches_one_device():
    """A prompt of 700 positions into the hybrid's 512-slot ring on (data
    1, model 4): each slot writes its slice of the wrapped ring; held to the
    port's unsharded prefill (codes at >= 0.999, scales 1e-5 relative,
    states and logits 1e-4)."""
    cfg = _cfg("hybrid")
    model = tt.init_params(cfg, 3, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 700), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want_cache, want = tt.prefill(model, cfg, toks)
        with partition.logical_axes(MAP2), partition.set_mesh(_mesh((1, 4))):
            cache, got = tt.prefill(model, cfg, toks)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
    _check_cache(_leaves(cache), {"w/" + k: v.numpy() for k, v in _leaves(want_cache).items()}, "w/")


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=lambda s: "%dx%d" % s)
def test_the_hybrid_ring_splits_only_where_its_scale_groups_divide(shape):
    """A 64-slot window's ring is one scale group: refused over 2 or 4 model
    slots, naming the rule, as the reference's `shard_map` refuses it."""
    cfg = get_arch("recurrentgemma-9b").model.reduced(dtype="float32")
    with partition.logical_axes(MAP2), partition.set_mesh(_mesh(shape)):
        with pytest.raises(ValueError, match=r"W / 64 % n == 0"):
            tt.init_decode_cache(cfg, 2, 300, "cpu")


def test_split_ssm_without_one_group_is_refused():
    cfg = dataclasses.replace(_cfg("ssm"), ssm_groups=2)
    with pytest.raises(ValueError, match="do not split"):
        ssd._slot_heads(cfg, 4, 0)


@contextlib.contextmanager
def _no_mesh():
    with partition.logical_axes(None), partition.set_mesh(None):
        yield


def test_data_only_mesh_serves_from_sharded_states():
    """(data 2, model 1): the states held as batch shards, each block
    stepping its gathered state and writing it back; equal to the port's
    unsharded serving."""
    cfg = _cfg("ssm")
    model = tt.init_params(cfg, 4, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        with _no_mesh():
            c0, l0 = tt.prefill(model, cfg, toks[:, :39])
            c0, d0 = tt.decode_step(model, cfg, c0, toks[:, 39:])
        with partition.logical_axes(MAP2), partition.set_mesh(_mesh((2, 1))):
            c1, l1 = tt.prefill(model, cfg, toks[:, :39])
            c1, d1 = tt.decode_step(model, cfg, c1, toks[:, 39:])
    assert isinstance(c1["layers"]["ssm_state"], sharding.Sharded)
    assert c1["layers"]["ssm_state"].shards[0].shape[1] == 1
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    torch.testing.assert_close(d1, d0, rtol=0, atol=0)
    for k, v in _leaves(c1).items():
        torch.testing.assert_close(v, _leaves(c0)[k], rtol=0, atol=0)


def test_ssd_gradients_stay_finite_where_the_masked_decay_overflows():
    """A full chunk of 256 at dt A = -1.6 a position (mamba2-1.3b's
    largest A with dt 0.1): above the diagonal the decay's exponent reaches
    ~408, past float32's exponential. The chunk scan masks the exponent, so
    its gradients are finite, and equal to the float64 ones (where nothing
    overflows) within 1e-4 in relative norm."""
    gen = torch.Generator().manual_seed(0)
    b, s, e, p, n = 1, 256, 2, 4, 8
    x0 = torch.randn(b, s, 1, e, p, generator=gen, dtype=torch.float64)
    dt0 = torch.full((b, s, 1, e), 0.1, dtype=torch.float64)
    a0 = torch.full((1, e), -16.0, dtype=torch.float64)
    bm, cm = (torch.randn(b, s, 1, n, generator=gen, dtype=torch.float64) for _ in range(2))
    w = torch.randn(b, s, 1, e, p, generator=gen, dtype=torch.float64)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        leaves = [t.to(dtype).requires_grad_() for t in (x0, dt0, a0)]
        y, h = ssd._ssd_chunk_scan(leaves[0], leaves[1], leaves[2], bm.to(dtype), cm.to(dtype),
                                   torch.zeros((b, 1, e, p, n), dtype=dtype), s)
        grads[dtype] = torch.autograd.grad((y * w.to(dtype)).sum() + h.sum(), leaves)
    for got, want in zip(grads[torch.float32], grads[torch.float64]):
        assert bool(torch.isfinite(got).all())
        assert float(torch.linalg.norm(got.double() - want) / torch.linalg.norm(want)) <= 1e-4
