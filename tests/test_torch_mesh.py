"""The port's mesh machinery held to the reference on four CPU slots:
the three `shard_map` sites (the distributed-LSE decode, the moe
per-data-shard dispatch and combine, the compressed gradient sync with
`param_specs`), the data-parallel train step, and sharded serving.

The reference runs once for the file, in a subprocess with
`--xla_force_host_platform_device_count=4`, its meshes built with Auto
axes (`jax.make_mesh(..., axis_types=(AxisType.Auto,) * n)` under
`jax.set_mesh`): jax 0.9.0 makes axes Explicit by default, under which the
reference's `partition.hint` asserts. Its inputs and outputs come back in
one npz; the port runs here on a `DeviceMesh` of four `cpu` slots.

Tolerances (float32), and why:
  * dlse: 1e-6 absolute on the output, the codes equal (the same blocked
    scan per slot and the same merge; measured ~2e-8). The sharded branch
    is held to the reference's sharded branch: it differs from the single
    view by ~2e-4 (the merge sums the slots' statistics in another order);
  * moe: kept (expert, slot) pairs equal, y within 1e-5 absolute and aux
    within 1e-6 relative (float32 products in another order; measured
    ~6e-7);
  * compressed sync: 1e-6 absolute (the same codes; a mean of dequantized
    values in another order);
  * train step: loss and ce within 1e-5 relative, grad_norm 1e-4, lr 1e-6,
    the parameters as `test_torch_train.py` holds one device's step: mean
    absolute difference 1e-6 and at most 0.1 % of a leaf's elements more
    than 1e-5 apart (an early AdamW step moves an element by ~lr * sign(g),
    and an element whose gradient is float32 noise can move the other way).
    With the compressed pod sync, a gradient within float32 noise of a
    mu-law code boundary lands one code apart, which moves that element's
    AdamW step by a few % of lr (measured 2.8e-5 at lr 1e-3, on the norm
    gammas): every element within 5e-5 and the mean over all elements
    within 1e-6;
  * serving: prefill logits within 1e-4, decode logits 2e-2, ring codes
    agreeing at >= 0.999: `test_torch_serve.py`'s tolerances and reasons.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.configs import get_arch
from repro_torch.core import gradient, kvcache
from repro_torch.launch import steps
from repro_torch.models import moe, partition
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_numpy, tree_to_named
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import sharding
from repro_torch.runtime.elastic import make_mesh, reshard

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

CPU = torch.device("cpu")
MAP2 = {"data": "data", "model": "model"}
MAP3 = {"data": ("pod", "data"), "model": "model"}
POS = 700

_REF = r'''
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.core import gradient, kvcache
from repro.launch import steps
from repro.models import moe, partition
from repro.models.transformer import init_params
from repro.optim import AdamWConfig
from repro.optim.adamw import AdamWState, adamw
from repro.runtime.sharding import param_specs, physical_specs, resolve

out = {}
MAP2 = {"data": "data", "model": "model"}
MAP3 = {"data": ("pod", "data"), "model": "model"}

def mesh_of(shape, names):
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))

def flat(prefix, tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = np.asarray(leaf)

# -- dlse
rng = np.random.default_rng(0)
B, W, K, Dh, H, POS = 2, 512, 2, 64, 4, 700
ins = dict(kc=rng.integers(0, 256, (B, W, K, Dh)).astype(np.uint8), vc=rng.integers(0, 256, (B, W, K, Dh)).astype(np.uint8),
           ks=rng.uniform(0.5, 2, (B, W // 128, K)).astype(np.float32), vs=rng.uniform(0.5, 2, (B, W // 128, K)).astype(np.float32),
           q=rng.normal(0, 1, (B, 1, H, Dh)).astype(np.float32), kt=rng.normal(0, 1, (B, 1, K, Dh)).astype(np.float32),
           vt=rng.normal(0, 1, (B, 1, K, Dh)).astype(np.float32))
out.update({"dlse_in_" + k: v for k, v in ins.items()})
dlse = jax.jit(lambda q, cl, kt, vt: kvcache.decode_attend_dlse(q, cl, kt, vt, jnp.int32(POS), None))
def dlse_run():
    cl = {"k_codes": ins["kc"], "v_codes": ins["vc"], "k_scale": ins["ks"], "v_scale": ins["vs"]}
    return dlse(ins["q"], jax.tree_util.tree_map(jnp.asarray, cl), ins["kt"], ins["vt"])
for shape in ((1, 4), (2, 2)):
    with jax.set_mesh(mesh_of(shape, ("data", "model"))), partition.logical_axes(MAP2):
        o, ncl = dlse_run()
    tag = "%dx%d" % shape
    out["dlse_out_" + tag] = np.asarray(o)
    out["dlse_kc_" + tag] = np.asarray(ncl["k_codes"]); out["dlse_vc_" + tag] = np.asarray(ncl["v_codes"])
out["dlse_out_single"] = np.asarray(dlse_run()[0])

# -- moe
mcfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b").model, d_model=64, d_ff=32, n_experts=16)
mp = moe.init_moe(jax.random.PRNGKey(3), mcfg, jnp.float32)
out.update({"moe_p_" + k: np.asarray(v) for k, v in mp.items()})
x = np.random.default_rng(1).normal(0, 1, (4, 16, 64)).astype(np.float32)
out["moe_x"] = x
mf = jax.jit(lambda p, x: moe.moe_ffn(p, mcfg, x))
out["moe_y_single"] = np.asarray(mf(mp, x)[0])
xt = jnp.asarray(x).reshape(-1, 64)
_, sel = jax.lax.top_k(jax.nn.softmax(xt @ mp["router"], axis=-1), mcfg.n_experts_per_token)
for shape in ((4, 1), (2, 2)):
    with jax.set_mesh(mesh_of(shape, ("data", "model"))), partition.logical_axes(MAP2):
        y, aux = mf(mp, x)
    tag = "%dx%d" % shape
    out["moe_y_" + tag] = np.asarray(y); out["moe_aux_" + tag] = np.asarray(aux)
    n, T = shape[0], xt.shape[0]
    cl = max(8, -(-moe.capacity(T, mcfg) // n))
    es, ss = zip(*[moe._dispatch_indices(sel[i * T // n:(i + 1) * T // n].reshape(-1), mcfg.n_experts, cl) for i in range(n)])
    out["moe_e_" + tag] = np.concatenate([np.asarray(e) for e in es]); out["moe_s_" + tag] = np.concatenate([np.asarray(s) for s in ss])

# -- compressed_grad_sync(param_specs=) on (pod 2, data 2, model 1)
mesh3 = mesh_of((2, 2, 1), ("pod", "data", "model"))
g = {"a": rng.normal(0, 0.01, (64, 48)).astype(np.float32), "b": rng.normal(0, 1, (8, 300)).astype(np.float32),
     "c": rng.normal(0, 0.1, (5000,)).astype(np.float32)}
gspecs = {"a": P(("pod", "data"), "model"), "b": P("pod", None), "c": P(None)}
out.update({"sync_in_" + k: v for k, v in g.items()})
with jax.set_mesh(mesh3):
    got = gradient.compressed_grad_sync(jax.tree_util.tree_map(jnp.asarray, g), mesh3, "pod",
                                        gradient.GradCompressionConfig(chunk=256), gspecs)
out.update({"sync_out_" + k: np.asarray(v) for k, v in got.items()})

# -- data-parallel train step on (pod 2, data 2, model 1)
cfg = get_arch("qwen3-1.7b").model.reduced(dtype="float32")
params = init_params(cfg, jax.random.PRNGKey(0))
flat("train_p0/", params)
toks = rng.integers(0, cfg.vocab_size, (3, 4, 33)).astype(np.int32)
out["train_toks"] = toks
opt = AdamWConfig(lr=1e-3)
for tag, comp, n_steps in (("comp", gradient.GradCompressionConfig(), 2), ("plain", None, 1)):
    with jax.set_mesh(mesh3), partition.logical_axes(MAP3):
        pl = param_specs(cfg, "train")
        pshard = resolve(pl, mesh3)
        _, step = steps.make_train_step(cfg, opt, steps.TrainStepConfig(grad_compression=comp), mesh=mesh3,
                                        param_pspecs=physical_specs(pl))
        oshard = AdamWState(step=NamedSharding(mesh3, P()), m=pshard, v=pshard)
        bshard = {k: NamedSharding(mesh3, P(("pod", "data"), None)) for k in ("inputs", "labels")}
        fn = jax.jit(step, in_shardings=(pshard, oshard, bshard))
        p = jax.tree_util.tree_map(jax.device_put, params, pshard)
        o = jax.tree_util.tree_map(jax.device_put, adamw(opt)[0](params), oshard)
        for i in range(n_steps):
            b = {"inputs": jnp.asarray(toks[i, :, :-1]), "labels": jnp.asarray(toks[i, :, 1:])}
            p, o, m = fn(p, o, b)
            for k in ("loss", "ce", "grad_norm", "lr"):
                out[f"train_{tag}_{i}_{k}"] = np.asarray(m[k])
    flat(f"train_{tag}_p/", p)
    flat(f"train_{tag}_m/", o.m)
# -- serving under a mesh: qwen3 on (data 1, model 4), the moe prefill on (data 4, model 1)
from repro.models.transformer import decode_step, prefill
scfg = get_arch("qwen3-1.7b").model.reduced(dtype="float32")
sp = init_params(scfg, jax.random.PRNGKey(1))
flat("serve_p/", sp)
stoks = rng.integers(0, scfg.vocab_size, (2, 502)).astype(np.int32)
out["serve_toks"] = stoks
with jax.set_mesh(mesh_of((1, 4), ("data", "model"))), partition.logical_axes(MAP2):
    cache, lg = jax.jit(lambda p, x: prefill(p, scfg, x, 512))(sp, stoks[:, :500])
    out["serve_prefill"] = np.asarray(lg)
    dec = jax.jit(lambda p, c, t: decode_step(p, scfg, c, t))
    for i in range(2):
        cache, lg = dec(sp, cache, stoks[:, 500 + i:501 + i])
        out[f"serve_decode_{i}"] = np.asarray(lg)
    out["serve_kc"] = np.asarray(cache["layers"]["k_codes"])
qcfg = get_arch("qwen3-moe-30b-a3b").model.reduced(dtype="float32")
qp = init_params(qcfg, jax.random.PRNGKey(2))
flat("moep_p/", qp)
qtoks = rng.integers(0, qcfg.vocab_size, (4, 64)).astype(np.int32)
out["moep_toks"] = qtoks
with jax.set_mesh(mesh_of((4, 1), ("data", "model"))), partition.logical_axes(MAP2):
    cache, lg = jax.jit(lambda p, x: prefill(p, qcfg, x))(qp, qtoks)
out["moep_prefill"] = np.asarray(lg)
out["moep_kc"] = np.asarray(cache["layers"]["k_codes"])
out["moep_prefill_single"] = np.asarray(jax.jit(lambda p, x: prefill(p, qcfg, x))(qp, qtoks)[1])
# -- one data-parallel step of the moe family on (pod 2, data 2, model 1)
mcfg2 = get_arch("qwen3-moe-30b-a3b").model.reduced(dtype="float32")
mp2 = init_params(mcfg2, jax.random.PRNGKey(4))
flat("moet_p0/", mp2)
mtoks = rng.integers(0, mcfg2.vocab_size, (4, 17)).astype(np.int32)
out["moet_toks"] = mtoks
with jax.set_mesh(mesh3), partition.logical_axes(MAP3):
    pl = param_specs(mcfg2, "train")
    pshard = resolve(pl, mesh3)
    _, step = steps.make_train_step(mcfg2, opt, steps.TrainStepConfig(), mesh=mesh3,
                                    param_pspecs=physical_specs(pl))
    oshard = AdamWState(step=NamedSharding(mesh3, P()), m=pshard, v=pshard)
    bshard = {k: NamedSharding(mesh3, P(("pod", "data"), None)) for k in ("inputs", "labels")}
    p = jax.tree_util.tree_map(jax.device_put, mp2, pshard)
    o = jax.tree_util.tree_map(jax.device_put, adamw(opt)[0](mp2), oshard)
    p, o, m = jax.jit(step, in_shardings=(pshard, oshard, bshard))(
        p, o, {"inputs": jnp.asarray(mtoks[:, :-1]), "labels": jnp.asarray(mtoks[:, 1:])})
    for k in ("loss", "ce", "grad_norm"):
        out["moet_" + k] = np.asarray(m[k])
flat("moet_p/", p)
np.savez(sys.argv[1], **out)
print("REF-MESH-OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [os.path.join(os.path.dirname(__file__), "..", "src"), env.get("PYTHONPATH", "")] if p)
    proc = subprocess.run([sys.executable, "-c", _REF, str(path)], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0 and "REF-MESH-OK" in proc.stdout, proc.stdout + proc.stderr
    return dict(np.load(path))


def _mesh(shape, names=("data", "model")):
    return make_mesh(shape, names, devices=[CPU] * int(np.prod(shape)))


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


def _ring(d):
    t = lambda k: torch.from_numpy(d["dlse_in_" + k].copy())
    return {"k_codes": t("kc"), "v_codes": t("vc"), "k_scale": t("ks"), "v_scale": t("vs")}


def _toks(d, k):
    return torch.from_numpy(d["dlse_in_" + k].copy())


CACHE_SPECS = {"k_codes": ("data", "model", None, None), "v_codes": ("data", "model", None, None),
               "k_scale": ("data", "model", None), "v_scale": ("data", "model", None)}


# ------------------------------------------------------------------ dlse --
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_dlse_sharded_branch_matches_the_reference(ref, shape):
    tag = "%dx%d" % shape
    mesh = _mesh(shape)
    compat.reset_wire()
    for held in ("sharded", "whole"):
        ring = _ring(ref)
        cl = reshard(ring, CACHE_SPECS, mesh, MAP2) if held == "sharded" else ring
        with partition.logical_axes(MAP2), partition.set_mesh(mesh):
            out, new = kvcache.decode_attend_dlse(_toks(ref, "q"), cl, _toks(ref, "kt"), _toks(ref, "vt"), POS, None)
        np.testing.assert_allclose(out.numpy(), ref["dlse_out_" + tag], rtol=0, atol=1e-6)
        got = sharding.gather(new)
        np.testing.assert_array_equal(got["k_codes"].numpy(), ref["dlse_kc_" + tag])
        np.testing.assert_array_equal(got["v_codes"].numpy(), ref["dlse_vc_" + tag])
    assert np.abs(ref["dlse_out_" + tag] - ref["dlse_out_single"]).max() > 1e-5
    wire = compat.wire_bytes()
    assert wire["pmax"] > 0 and wire["psum"] > 0


@pytest.mark.parametrize("case", ["no mapping", "model width 1", "ring not divisible", "tuple model entry"])
def test_dlse_falls_back_to_the_single_view(ref, case):
    """The reference's fallback conditions take the single view: the port's
    output then equals its own single view bit for bit. A ring held as
    shards is read per data shard on the shard's slot ("model width 1":
    two data shards of one row), so its output equals the single view of
    each shard's rows."""
    want, _ = kvcache.decode_attend_dlse(_toks(ref, "q"), _ring(ref), _toks(ref, "kt"), _toks(ref, "vt"), POS, None)
    mesh, mapping = _mesh((1, 4)), MAP2
    ring = _ring(ref)
    if case == "model width 1":
        rows = [kvcache.decode_attend_dlse(_toks(ref, "q")[i:i + 1], {k: v[i:i + 1] for k, v in _ring(ref).items()},
                                           _toks(ref, "kt")[i:i + 1], _toks(ref, "vt")[i:i + 1], POS, None)[0]
                for i in range(2)]
        want = torch.cat(rows)
        mesh = _mesh((2, 1))
        ring = reshard(ring, CACHE_SPECS, mesh, mapping)
    elif case == "ring not divisible":
        mesh = _mesh((1, 3))
    elif case == "tuple model entry":
        mesh, mapping = _mesh((1, 2, 2), ("data", "m1", "m2")), {"data": "data", "model": ("m1", "m2")}
    with partition.logical_axes(None if case == "no mapping" else mapping), partition.set_mesh(mesh):
        got, new = kvcache.decode_attend_dlse(_toks(ref, "q"), ring, _toks(ref, "kt"), _toks(ref, "vt"), POS, None)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(sharding.gather(new)["k_codes"].numpy(), ref["dlse_kc_1x4"])


# ------------------------------------------------------------------- moe --
def _moe_cfg():
    return dataclasses.replace(get_arch("qwen3-moe-30b-a3b").model, d_model=64, d_ff=32, n_experts=16)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_moe_per_shard_dispatch_matches_the_reference(ref, shape):
    tag = "%dx%d" % shape
    cfg = _moe_cfg()
    p = {k: torch.from_numpy(ref["moe_p_" + k]) for k in ("router", "w_gate", "w_up", "w_down")}
    x = torch.from_numpy(ref["moe_x"])
    mesh = _mesh(shape)
    with partition.logical_axes(MAP2), partition.set_mesh(mesh):
        assert partition.data_shards() == ("data", shape[0])
        y, aux = moe.moe_ffn(p, cfg, x)
    np.testing.assert_allclose(y.numpy(), ref["moe_y_" + tag], rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(ref["moe_aux_" + tag]), rtol=1e-6)
    n, t = shape[0], x.shape[0] * x.shape[1]
    _, sel, _, _ = moe.route(p["router"], cfg, x.reshape(t, -1))
    e, slot = moe.shard_dispatch(sel, cfg, n, max(8, -(-moe.capacity(t, cfg) // n)))
    np.testing.assert_array_equal(e.numpy(), ref["moe_e_" + tag])
    np.testing.assert_array_equal(slot.numpy(), ref["moe_s_" + tag])
    if shape == (4, 1):  # the capacity is per shard: other pairs drop than unsharded
        assert np.abs(ref["moe_y_4x1"] - ref["moe_y_single"]).max() > 1e-2


def test_moe_batch_one_decode_takes_the_unsharded_branch(ref):
    """T % n_shards != 0 (a batch-1 decode) routes all tokens at once."""
    cfg = _moe_cfg()
    p = {k: torch.from_numpy(ref["moe_p_" + k]) for k in ("router", "w_gate", "w_up", "w_down")}
    x = torch.from_numpy(ref["moe_x"][:1, :3])
    want = moe.moe_ffn(p, cfg, x)[0]
    with partition.logical_axes(MAP2), partition.set_mesh(_mesh((4, 1))):
        assert torch.equal(moe.moe_ffn(p, cfg, x)[0], want)


# ------------------------------------------------------ gradient sync --
def test_compressed_grad_sync_param_specs_matches_the_reference(ref):
    """(pod 2, data 2, model 1): the sync runs in the two groups of slots
    sharing a data coordinate; "b"'s spec splits its rows over pod, so each
    pod averages its own row slice with the other's (the reference's local
    views); ("pod", "data") leaves "a" whole."""
    mesh = _mesh((2, 2, 1), ("pod", "data", "model"))
    g = {k: torch.from_numpy(ref["sync_in_" + k]) for k in "abc"}
    specs = {"a": (("pod", "data"), "model"), "b": ("pod", None), "c": (None,)}
    compat.reset_wire()
    got = gradient.compressed_grad_sync([g] * 4, mesh, "pod", gradient.GradCompressionConfig(chunk=256), specs)
    assert len(got) == 4
    for slot in got:
        for k in "abc":
            np.testing.assert_allclose(slot[k].numpy(), ref["sync_out_" + k], rtol=0, atol=1e-6)
    assert compat.wire_bytes()["compressed"] > 0


# ------------------------------------------------------------ train step --
def _assert_params_close(got: dict, want: dict, compressed: bool = False):
    total, n = 0.0, 0
    for k, w in want.items():
        d = np.abs(got[k].numpy() - w)
        total, n = total + float(d.sum()), n + d.size
        if compressed:
            assert d.max() <= 5e-5, (k, d.max())
            continue
        far = float((d > 1e-5).mean())
        assert far <= 1e-3 and d.mean() <= 1e-6, (k, d.max(), d.mean(), far)
    assert total / n <= 1e-6


@pytest.mark.parametrize("tag,comp,n_steps", [("comp", gradient.GradCompressionConfig(), 2), ("plain", None, 1)])
def test_data_parallel_train_step_matches_the_reference(ref, tag, comp, n_steps):
    cfg = get_arch("qwen3-1.7b").model.reduced(dtype="float32")
    mesh = _mesh((2, 2, 1), ("pod", "data", "model"))
    p0 = {k: torch.from_numpy(np.array(v)) for k, v in tree_to_named(_tree(ref, "train_p0/")).items()}
    toks = torch.from_numpy(ref["train_toks"])
    with partition.logical_axes(MAP3):
        specs = sharding.param_specs(cfg, "train")
        init, step = steps.make_train_step(cfg, AdamWConfig(lr=1e-3), steps.TrainStepConfig(grad_compression=comp),
                                           mesh=mesh, param_pspecs=sharding.physical_specs(specs), device="cpu")
        _, opt = init(0)
    params = reshard(p0, specs, mesh, MAP3)
    for i in range(n_steps):
        params, opt, m = step(params, opt, {"inputs": toks[i, :, :-1], "labels": toks[i, :, 1:]})
        for k, tol in (("loss", 1e-5), ("ce", 1e-5), ("grad_norm", 1e-4), ("lr", 1e-6)):
            np.testing.assert_allclose(float(m[k]), float(ref[f"train_{tag}_{i}_{k}"]), rtol=tol)
    assert int(opt.step) == n_steps
    _assert_params_close(sharding.gather(params), tree_to_named(_tree(ref, f"train_{tag}_p/")), comp is not None)
    _assert_params_close(sharding.gather(opt.m), tree_to_named(_tree(ref, f"train_{tag}_m/")), comp is not None)
    # every slot holds its own shard of the FSDP'd masters and moments
    wq = params["layers.0.attn.wq"]
    assert len(wq.shards) == 4 and tuple(wq.shards[0].shape) == (wq.shape[0] // 4, wq.shape[1])


def test_moe_data_parallel_train_step_matches_the_reference(ref):
    """The moe family: per-shard capacity in each slot's program, and each
    slot's load-balance loss its share of the global one."""
    cfg = get_arch("qwen3-moe-30b-a3b").model.reduced(dtype="float32")
    mesh = _mesh((2, 2, 1), ("pod", "data", "model"))
    p0 = {k: torch.from_numpy(np.array(v)) for k, v in tree_to_named(_tree(ref, "moet_p0/")).items()}
    toks = torch.from_numpy(ref["moet_toks"])
    with partition.logical_axes(MAP3):
        specs = sharding.param_specs(cfg, "train")
        init, step = steps.make_train_step(cfg, AdamWConfig(lr=1e-3), mesh=mesh,
                                           param_pspecs=sharding.physical_specs(specs), device="cpu")
        _, opt = init(0)
    params, opt, m = step(reshard(p0, specs, mesh, MAP3), opt, {"inputs": toks[:, :-1], "labels": toks[:, 1:]})
    for k, tol in (("loss", 1e-5), ("ce", 1e-5), ("grad_norm", 1e-4)):
        np.testing.assert_allclose(float(m[k]), float(ref["moet_" + k]), rtol=tol)
    _assert_params_close(sharding.gather(params), tree_to_named(_tree(ref, "moet_p/")))


# --------------------------------------------------------------- serving --
def test_sharded_decode_matches_the_reference(ref):
    """qwen3-1.7b reduced, the ring over (data 1, model 4): prefill writes
    the ring's shards, each decode step reads them through the
    distributed-LSE branch."""
    cfg = get_arch("qwen3-1.7b").model.reduced(dtype="float32")
    model = params_from_numpy(_tree(ref, "serve_p/"), cfg, "cpu")
    toks = torch.from_numpy(ref["serve_toks"])
    mesh = _mesh((1, 4))
    with torch.no_grad(), partition.logical_axes(MAP2), partition.set_mesh(mesh):
        cache, lg = tt.prefill(model, cfg, toks[:, :500], 512)
        ring = cache["layers"]["k_codes"]
        assert isinstance(ring, sharding.Sharded) and tuple(ring.shards[0].shape)[2] == ring.shape[2] // 4
        np.testing.assert_allclose(lg.numpy(), ref["serve_prefill"], rtol=0, atol=1e-4)
        for i in range(2):
            cache, lg = tt.decode_step(model, cfg, cache, toks[:, 500 + i:501 + i])
            np.testing.assert_allclose(lg.numpy(), ref[f"serve_decode_{i}"], rtol=0, atol=2e-2)
    rate = float((cache["layers"]["k_codes"].gather().numpy() == ref["serve_kc"]).mean())
    assert rate >= 0.999


def test_sharded_moe_prefill_matches_the_reference(ref):
    """qwen3-moe reduced over (data 4, model 1): per-shard dispatch in
    every moe layer, B10 per data shard, the ring's batch over data."""
    cfg = get_arch("qwen3-moe-30b-a3b").model.reduced(dtype="float32")
    model = params_from_numpy(_tree(ref, "moep_p/"), cfg, "cpu")
    toks = torch.from_numpy(ref["moep_toks"])
    with torch.no_grad(), partition.logical_axes(MAP2), partition.set_mesh(_mesh((4, 1))):
        cache, lg = tt.prefill(model, cfg, toks)
    np.testing.assert_allclose(lg.numpy(), ref["moep_prefill"], rtol=0, atol=1e-4)
    assert np.abs(ref["moep_prefill"] - ref["moep_prefill_single"]).max() > 1e-2
    assert float((cache["layers"]["k_codes"].gather().numpy() == ref["moep_kc"]).mean()) >= 0.999


# ---------------------------------------------------------- train(mesh=) --
def test_train_on_a_mesh_checkpoints_in_the_references_format(tmp_path):
    """`train(mesh=...)` with a checkpoint every step and a fault at step
    2: the sharded state is gathered into the reference's checkpoint tree
    (`state_tree`, the format `tests/test_torch_train.py` holds both
    trainers to), the run restarts from it, and the port's one-device
    trainer resumes from the last one."""
    from repro_torch.launch import train as ttrain

    cfg = get_arch("qwen3-1.7b").model.reduced()
    mesh = _mesh((2, 1, 1), ("pod", "data", "model"))
    with partition.logical_axes(MAP3):
        run = ttrain.train(cfg, steps=3, batch=4, seq=16, checkpoint_dir=str(tmp_path), checkpoint_every=1,
                           fail_at=(2,), device="cpu", mesh=mesh, grad_compression=gradient.GradCompressionConfig(),
                           log_every=100)
    assert (run.restarts, run.final_step) == (1, 3) and all(np.isfinite(run.losses))
    got = ttrain.train(cfg, steps=4, batch=2, seq=16, checkpoint_dir=str(tmp_path), resume=True, device="cpu")
    assert got.final_step == 4 and len(got.losses) == 1


def test_hint_checks_a_slot_programs_shard():
    mesh = _mesh((2, 1, 1), ("pod", "data", "model"))
    x = torch.zeros(2, 5, 3)
    with partition.logical_axes(MAP3):
        assert partition.hint(x, "data", None, None) is x  # whole tensors: the identity
        with partition.slot_program(mesh, 1, {"data": (4, 2)}):
            assert partition.hint(x, "data", None, None) is x
            with pytest.raises(ValueError, match="shard"):
                partition.hint(torch.zeros(4, 5, 3), "data", None, None)
