"""Training split over the model axis on the card (ROADMAP A10 items
6b-6d): `chip_smoke.py`'s tp_train phase, its card-against-CPU check
(`check_split_train_card_vs_cpu`: the loss, the aux loss, the gradient
norm, AdamW's first moment and the updates shard by shard, the moe routing
in the forward and in the recompute, the dropped pairs) on a (pod 1, data
1, model 4) mesh under chip_smoke's MAP3.

The CPU tests run the check's machinery with both sides on CPU slots, at
the small widths that tests/test_torch_tp.py and
tests/test_torch_tp_recurrent.py hold against the reference (experts split,
each expert's d_ff split, and the hybrid at 3 layers: one whole group), and
tie the card's mesh to the one those files hold: the split step on (pod 1,
data 1, model 4) under MAP3 equals the step on (data 1, model 4) under
MAP2, leaf by leaf. The card test is marked `cuda` and skips without a
GPU. None imports jax or the reference."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import partition  # noqa: E402
from repro_torch.models.convert import params_to_numpy, tree_to_named  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import sharding  # noqa: E402
from repro_torch.runtime.elastic import make_mesh, reshard  # noqa: E402

CPU = torch.device("cpu")
#: the small configs, as tests/test_torch_tp.py's and
#: tests/test_torch_tp_recurrent.py's CONFIGS build them (the hybrid at 3
#: layers), keyed by the tp_train path's arch; each trained under full
#: remat as the full configs are
CONFIGS = {
    "ep": ("qwen3-moe-30b-a3b", {"n_experts": 16}),
    "tp_expert": ("mixtral-8x7b", {"swa_window": 512}),
    "hybrid": ("recurrentgemma-9b", {"local_window": 512, "n_layers": 3}),
}


def _cfg(tag):
    arch, over = CONFIGS[tag]
    return get_arch(arch).model.reduced(dtype="float32", remat="full", **over)


def _spec(tag):
    return next(s for s in chip_smoke.TP_TRAIN_SPLIT if s["arch"] == CONFIGS[tag][0])


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one CPU thread: the steps here are many small ops over
    four slots, which torch's thread pool slows when the suite's workers
    share the cores (~17x under six workers on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """The card, or skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tag", list(CONFIGS))
def test_split_train_check_card_against_cpu(cuda, tag):
    """The tp_train path's check at full width and its check depth."""
    out = chip_smoke.check_split_train_card_vs_cpu(cuda, _spec(tag))
    assert set(out) == {"float32", "bfloat16"} and all(r["finite"] for r in out.values())


@pytest.mark.parametrize("tag", list(CONFIGS))
def test_split_train_check_machinery_on_the_cpu(tag):
    """Both sides on CPU slots: the same numbers, every moment and update
    compared, the routing recorded twice a layer on every slot alike. The
    moments agree to float32 summation order: the vocab-split embedding's
    gradient is an accumulating index-put, whose CPU kernel adds repeated
    tokens' rows atomically, in the order its threads meet them (one of
    its rows 5.8e-11 apart between two runs of one side), and the
    gradient norm that clips every leaf moves with it."""
    cfg = _cfg(tag)
    out = chip_smoke.check_split_train_card_vs_cpu(CPU, _spec(tag), cfg)
    assert set(out) == {"float32", "bfloat16"}
    for r in out.values():
        assert r["loss_rel"] == 0.0
        assert max(r["grad_norm_rel"], r["moment_rel_max"], r["update_rel_max"]) < 1e-6
        assert r["finite"] and r["loss_card"] > 0
        if cfg.family == "moe":
            assert r["aux_rel"] == 0.0 and r["aux_card"] > 0
            assert r["sel_agreement"] == r["sel_set_agreement"] == 1.0
            assert r["slots_route_alike"] == {"card": True, "cpu": True}
            assert len(r["layers"]) == cfg.n_layers
            assert all(layer["remat_routes_alike"] == {"card": True, "cpu": True} and layer["experts_left_out"] == 0
                       for layer in r["layers"])
        else:
            assert "aux_card" not in r
    assert out["bfloat16"]["gated"] == ("finite, loss, aux" if cfg.family == "moe" else "all")


@pytest.mark.parametrize("tag", list(CONFIGS))
def test_the_card_mesh_steps_as_the_reference_held_mesh(tag):
    """The split step on (pod 1, data 1, model 4) under MAP3 against the
    same step on (data 1, model 4) under MAP2, the mesh and mapping that
    tests/test_torch_tp.py and tests/test_torch_tp_recurrent.py hold to the
    reference: the metrics, every slot's shard of AdamW's moments and of
    the masters, equal up to the order in which the embedding gradient's
    accumulating index-put adds repeated tokens' rows on the CPU."""
    cfg = _cfg(tag)
    named = tree_to_named(params_to_numpy(init_params(cfg, seed=3, device="cpu", param_dtype="float32")))
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, (4, 17)).astype(np.int32))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    got = []
    for shape, names, mapping in (((1, 1, 4), ("pod", "data", "model"), chip_smoke.MAP3),
                                  ((1, 4), ("data", "model"), chip_smoke.MAP2)):
        mesh = make_mesh(shape, names, devices=[CPU] * 4)
        with partition.logical_axes(mapping):
            specs = sharding.param_specs(cfg, "train")
            init, step = steps.make_train_step(cfg, AdamWConfig(lr=1e-3), mesh=mesh,
                                               param_pspecs=sharding.physical_specs(specs), device="cpu")
            _, opt = init(0)
        params = reshard({k: torch.from_numpy(named[k]) for k in specs}, specs, mesh, mapping)
        params, opt, met = step(params, opt, batch)
        got.append((params, opt, met))
    (p3, o3, m3), (p2, o2, m2) = got
    assert torch.equal(m3["loss"], m2["loss"]) and torch.equal(m3["ce"], m2["ce"])
    torch.testing.assert_close(m3["grad_norm"], m2["grad_norm"], rtol=1e-6, atol=0)
    for tree3, tree2 in ((p3, p2), (o3.m, o2.m), (o3.v, o2.v)):
        assert tree3.keys() == tree2.keys()
        for k, t in tree3.items():
            assert t.shape == tree2[k].shape and len(t.shards) == 4
            for a, b in zip(t.shards, tree2[k].shards):
                if k == "embed":
                    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-9)
                else:
                    assert torch.equal(a, b), k


def test_split_routes_records_each_slot_and_the_recompute():
    """The ep config's split step under `split_routes`: a router per layer
    and slot in first-call order (layer-major), each called by the forward
    and by full remat's recompute with the same routing."""
    cfg = _cfg("ep")
    named = {k: p.detach() for k, p in init_params(cfg, seed=0, device="cpu", param_dtype="float32")
             .named_parameters()}
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    out = chip_smoke.split_train_side(CPU, cfg, named, tokens, _spec("ep"))
    assert out["slots_route_alike"] and out["aux"] > 0
    assert set(out["routes"]) == set(range(cfg.n_layers))
    for fwd, rec in out["routes"].values():
        assert fwd.shape == (2 * 32, cfg.n_experts_per_token) and torch.equal(fwd, rec)
    # AdamW's moment and the update of every leaf, one shard a slot
    assert set(out["m"]) == set(out["updates"]) == set(named)
    assert all(len(v) == 4 for v in out["m"].values())


def test_the_held_back_adamw_takes_the_cpu_side_as_the_step_would():
    """The CPU side with AdamW held back (`adamw_inputs`), its clipped
    gradient taken through `host_adamw`, against the whole step on the
    same slots: AdamW's moment and the update of every leaf alike (the
    embedding's up to its accumulating index-put's order)."""
    cfg = _cfg("tp_expert")
    named = {k: p.detach() for k, p in init_params(cfg, seed=0, device="cpu", param_dtype="float32")
             .named_parameters()}
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    spec = _spec("tp_expert")
    host = chip_smoke.split_train_side(CPU, cfg, named, tokens, spec, host=True)
    whole = chip_smoke.split_train_side(CPU, cfg, named, tokens, spec)
    assert "m" not in host and set(host["g"]) == set(whole["m"])
    assert host["loss"] == whole["loss"] and host["grad_norm"] == pytest.approx(whole["grad_norm"], rel=1e-6)
    for k in list(host["g"]):
        m, u = chip_smoke.host_adamw(CPU, named, k, host, whole)
        for got, want in ((m, whole["m"][k]), (u, whole["updates"][k])):
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=1e-5 if k == "embed" else 0, atol=1e-9 if k == "embed" else 0)
    assert not host["g"]


@pytest.mark.parametrize("expert_split", [True, False], ids=["ep", "tp_expert"])
def test_shards_rel_compares_each_slots_rows(expert_split):
    """A leaf of 2 slots' shards, 2 experts' rows each under an expert
    split (4 experts) or every expert's rows under a d_ff split (2
    experts), differing on slot 1's row 1 alone: 0 apart with that expert
    left out, apart when every row counts."""
    card = [torch.ones(2, 3), torch.ones(2, 3)]
    host = [torch.ones(2, 3), torch.ones(2, 3)]
    host[1][1] = 5.0
    if expert_split:
        alike = torch.tensor([True, True, True, False])
        rows = (lambda s: alike[2 * s:2 * s + 2])
    else:
        alike = torch.tensor([True, False])
        rows = (lambda s: alike)
    assert chip_smoke.shards_rel(CPU, card, host, rows) == (0.0, True)
    rel, finite = chip_smoke.shards_rel(CPU, card, host)
    assert finite and rel == pytest.approx(np.sqrt(3 * 16 / (6 + 3 + 3 * 25)))


def test_each_path_is_reckoned_inside_the_card():
    """The reckoning each tp_train path prints (16 bytes a parameter, 2 for
    the bf16 copies, a slot's AdamW temporaries): every path at its depth
    leaves 10 GB of the card's 80 for activations, and one more layer of
    mixtral-8x7b would not."""
    for spec in chip_smoke.TP_TRAIN_SPLIT:
        cfg = dataclasses.replace(get_arch(spec["arch"]).model, n_layers=spec["n_layers"])
        assert chip_smoke.reckoned_bytes(cfg, spec["shape"][-1]) < 70e9, spec["arch"]
    mixtral = next(s for s in chip_smoke.TP_TRAIN_SPLIT if s["arch"] == "mixtral-8x7b")
    deeper = dataclasses.replace(get_arch("mixtral-8x7b").model, n_layers=mixtral["n_layers"] + 1)
    assert chip_smoke.reckoned_bytes(deeper, 4) > 80e9
