"""The port's sharding policy (`repro_torch.runtime.sharding`,
`models/partition.py`, `launch/mesh.py`, `elastic.reshard`) against the
reference's (`repro.runtime.sharding`).

The reference's spec functions need no devices (`jax.eval_shape`), and its
`NamedSharding.shard_shape` takes an `AbstractMesh`, so the reference runs
in this process. Every comparison is exact: specs are tuples of names,
shard shapes integers, and a reshard followed by a gather copies bytes.
"""
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, NamedSharding, PartitionSpec as P

from repro.configs import arch_ids as rarch_ids
from repro.configs import get_arch as rget
from repro.launch import mesh as rmesh
from repro.models import partition as rpart
from repro.runtime import sharding as rsh
from repro_torch.configs import arch_ids, get_arch
from repro_torch.launch import mesh as tmesh
from repro_torch.models import partition as tpart
from repro_torch.models.convert import STACKS
from repro_torch.runtime import sharding as tsh
from repro_torch.runtime.elastic import ElasticSession, make_mesh, reshard

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

CPU = torch.device("cpu")


def _ref_named(tree, shapes) -> dict:
    """The reference's stacked spec tree keyed by the port's parameter
    names: row i of a stacked leaf drops the leading layer entry."""
    import jax

    out = {}
    flat_s = dict((jax.tree_util.keystr(p), s) for p, s in jax.tree_util.tree_leaves_with_path(shapes))
    for path, spec in jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, tuple)):
        keys = [k.key for k in path]
        if keys[0] in STACKS:
            n = flat_s[jax.tree_util.keystr(path)].shape[0]
            for i in range(n):
                out[".".join([keys[0], str(i)] + keys[1:])] = tuple(spec[1:])
        else:
            out[".".join(keys)] = tuple(spec)
    return out


def test_the_port_registers_the_references_archs():
    assert sorted(arch_ids()) == sorted(rarch_ids())


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", sorted(rarch_ids()))
def test_param_specs_equal_the_references(arch, mode):
    import jax

    from repro.models.transformer import init_params

    rcfg = rget(arch).model
    shapes = jax.eval_shape(lambda k: init_params(rcfg, k), jax.random.PRNGKey(0))
    want = _ref_named(rsh.param_specs(rcfg, mode), shapes)
    got = tsh.param_specs(get_arch(arch).model, mode)
    assert got == want


@pytest.mark.parametrize("arch", sorted(rarch_ids()))
def test_cache_specs_equal_the_references(arch):
    shapes = [s for s in rget(arch).runnable_shapes() if s.kind == "decode"] or [None]
    for shape in shapes:
        b, s = (shape.global_batch, shape.seq_len) if shape else (4, 4096)
        want = rsh.cache_specs(rget(arch).model, b, s)
        got = tsh.cache_specs(get_arch(arch).model, b, s)
        assert got == want, (arch, b, s)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "musicgen-large"])
def test_batch_specs_equal_the_references(arch):
    for kind in ("train", "prefill", "decode"):
        for data_ok in (True, False):
            assert tsh.batch_specs(get_arch(arch).model, kind, data_ok) == \
                rsh.batch_specs(rget(arch).model, kind, data_ok)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_and_resolution(multi_pod):
    """The production meshes (slots on `meta`) and the physical specs and
    shard shapes of every qwen3-moe and deepseek parameter under the
    single-pod and multi-pod mappings."""
    import jax

    from repro.models.transformer import init_params

    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    assert (mesh.shape, mesh.axis_names) == (shape, names)
    assert mesh.size == int(np.prod(shape)) and set(mesh.devices) == {torch.device("meta")}
    mapping = tmesh.logical_mapping(multi_pod)
    assert mapping == rmesh.logical_mapping(multi_pod)
    amesh = AbstractMesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
    for arch in ("qwen3-moe-30b-a3b", "deepseek-coder-33b"):
        rcfg, tcfg = rget(arch).model, get_arch(arch).model
        shapes = jax.eval_shape(lambda k: init_params(rcfg, k), jax.random.PRNGKey(0))
        with rpart.logical_axes(mapping):
            rphys = _ref_named(rsh.physical_specs(rsh.param_specs(rcfg, "train")), shapes)
        with tpart.logical_axes(mapping):
            logical = tsh.param_specs(tcfg, "train")
            tphys = tsh.physical_specs(logical)
            placements = tsh.resolve(logical, mesh)
        assert tphys == {k: tuple(v) for k, v in rphys.items()}
        flat = {jax.tree_util.keystr(p): s for p, s in jax.tree_util.tree_leaves_with_path(shapes)}
        model_shapes = {name: tuple(p.shape) for name, p in _meta_model(tcfg).named_parameters()}
        for name, pl in list(placements.items())[:40]:
            full = model_shapes[name]
            want = NamedSharding(amesh, P(*tphys[name])).shard_shape(full)
            assert pl.shard_shape(full) == tuple(want), name
        assert flat


def _meta_model(cfg):
    from repro_torch.models.transformer import Transformer

    return Transformer(cfg, "meta", param_dtype=cfg.param_dtype)


def test_host_mesh_and_partition_spec():
    mesh = tmesh.make_host_mesh(4, device="cpu")
    assert mesh.shape == (1, 1) and mesh.axis_names == ("data", "model")
    mapping = {"data": ("pod", "data"), "model": "model"}
    with tpart.logical_axes(mapping), rpart.logical_axes(mapping):
        assert tpart.spec("data", None, "model") == tuple(
            rpart.spec("data", None, "model")) == (("pod", "data"), None, "model")
    x = torch.zeros(4, 3)
    assert tpart.hint(x, "data", None) is x  # the identity outside a mesh


MESHES = [((2, 2, 1), ("pod", "data", "model"), {"data": ("pod", "data"), "model": "model"}),
          ((1, 4), ("data", "model"), {"data": "data", "model": "model"}),
          ((2, 2), ("data", "model"), {"data": "data", "model": "model"})]


@pytest.mark.parametrize("shape,names,mapping", MESHES)
def test_reshard_shapes_and_gather_identity(shape, names, mapping):
    """`reshard` cuts each leaf into the shard shapes `NamedSharding`
    gives on the same mesh and specs, each slot's slice of the whole, and
    `gather` reads the whole tensors back bit for bit."""
    cfg = get_arch("qwen3-1.7b").model.reduced()
    mesh = make_mesh(shape, names, devices=[CPU] * int(np.prod(shape)))
    amesh = AbstractMesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
    rng = np.random.default_rng(0)
    specs = tsh.param_specs(cfg, "train")
    tree = {k: torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32))
            for k, p in _meta_model(cfg).named_parameters()}
    cspecs = tsh.cache_specs(cfg, 4, 512)
    from repro_torch.models.transformer import init_decode_cache

    cache = init_decode_cache(cfg, 4, 512, device="cpu")
    for leaf in cache["layers"].values():
        leaf.copy_(torch.from_numpy(rng.integers(0, 200, tuple(leaf.shape))).to(leaf.dtype))
    for t, sp in ((tree, specs), (cache, cspecs)):
        sharded = reshard(t, sp, mesh, mapping)
        flat = tsh.tree_map(lambda x, s: (x, s), sharded, sp,
                            is_leaf=lambda x: isinstance(x, tsh.Sharded) or not isinstance(x, dict))
        n = 0
        for x, s in _leaves(flat):
            if not isinstance(x, tsh.Sharded):
                continue
            with tpart.logical_axes(mapping):
                phys = tpart.spec(*s)
            want = NamedSharding(amesh, P(*phys)).shard_shape(x.shape)
            assert all(tuple(sh.shape) == tuple(want) for sh in x.shards)
            assert all(sh.device == CPU for sh in x.shards)
            n += 1
        assert n > 0
        back = tsh.gather(sharded)
        for a, b in zip(_tensors(back), _tensors(t)):
            assert torch.equal(a, b)
    # a Sharded tree reshards onto another mesh (a re-mesh): gathered first
    two = make_mesh((2,), ("data",), devices=[CPU] * 2)
    again = reshard(reshard(tree, specs, mesh, mapping), specs, two, {"data": "data", "model": None})
    assert all(torch.equal(a, b) for a, b in zip(_tensors(tsh.gather(again)), _tensors(tree)))


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def _tensors(node):
    for x in _leaves(node):
        if isinstance(x, torch.Tensor):
            yield x


def test_elastic_session_shardings_for():
    """The lm profile keeps the model axis widest: 4 slots plan (1, 4)."""
    es = ElasticSession(4, devices=[CPU] * 4)
    from repro.runtime.elastic import plan_mesh

    assert (es.mesh.shape, es.mesh.axis_names) == plan_mesh(4) == ((1, 4), ("data", "model"))
    pl = es.shardings_for({"w": ("data", "model"), "b": ()})
    assert pl["w"].spec == ("data", "model") and pl["b"].spec == ()
    assert pl["w"].shard_shape((8, 8)) == (8, 2)
    assert [pl["w"].slices((8, 8), s)[1] for s in range(4)] == [slice(i * 2, i * 2 + 2) for i in range(4)]
