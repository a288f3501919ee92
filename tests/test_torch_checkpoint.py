"""The port's checkpoints (`repro_torch.checkpoint`) in the reference's
on-disk format: the reference's own checks (`tests/test_checkpoint.py`)
mirrored, and checkpoints written by either package loaded by the other
with `like=` (the port writes no jax treedef; the reference then needs
`like=` too), leaf for leaf equal, AdamW's NamedTuple state and a training
state included."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.manager as RM
import repro_torch.checkpoint.manager as TM
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw as radamw
from repro_torch.checkpoint import CheckpointManager, latest_step, load_checkpoint, save_checkpoint
from repro_torch.checkpoint.manager import _COMMIT_SUFFIX, committed_steps, tree_flatten
from repro_torch.optim import AdamWConfig, adamw

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores


def tree():
    return {
        "w": torch.arange(24.0).reshape(4, 6),
        "nested": {"b": torch.ones((7,), dtype=torch.int32), "scalar": torch.tensor(2.5)},
    }


def assert_tree_equal(a, b):
    la, lb = tree_flatten(a), tree_flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_roundtrip(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 3, tree())
    assert latest_step(d) == 3
    assert_tree_equal(load_checkpoint(d, 3, like=tree()), tree())


def test_roundtrip_compressed(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, tree(), codec="zlib")
    assert_tree_equal(load_checkpoint(d, 1, like=tree()), tree())


def test_load_onto_a_device(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, tree())
    got = load_checkpoint(d, 1, device="cpu", like=tree())
    assert isinstance(got["w"], torch.Tensor) and got["nested"]["b"].dtype == torch.int32
    assert_tree_equal(got, tree())


def test_atomic_no_commit_marker_means_invisible(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 5, tree())
    os.remove(os.path.join(d, f"step_{5:09d}" + _COMMIT_SUFFIX))
    assert latest_step(d) is None


def test_leftover_tmp_dir_is_invisible_and_overwritten(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, f"step_{4:09d}.tmp-1"))
    os.makedirs(os.path.join(d, f"step_{4:09d}"))  # an uncommitted step
    assert committed_steps(d) == []
    save_checkpoint(d, 4, tree())
    assert committed_steps(d) == [4]
    assert_tree_equal(load_checkpoint(d, 4, like=tree()), tree())


def test_corruption_detected_and_fallback(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, tree())
    save_checkpoint(d, 2, tree())
    step_dir = os.path.join(d, f"step_{2:09d}")
    target = next(f for f in sorted(os.listdir(step_dir)) if f.endswith(".bin"))
    p = os.path.join(step_dir, target)
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[:-1] + bytes([raw[-1] ^ 0xFF]))
    with pytest.raises(ValueError):
        load_checkpoint(d, 2, like=tree())
    step, got = CheckpointManager(d).restore_latest(like=tree())
    assert step == 1
    assert_tree_equal(got, tree())


def test_async_manager_and_retention(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, tree())
    mgr.wait()
    assert committed_steps(d) == [3, 4]


def test_async_snapshot_is_taken_at_the_call(tmp_path):
    """The caller may update its tensors in place right after save_async."""
    d = str(tmp_path)
    t = tree()
    mgr = CheckpointManager(d)
    mgr.save_async(1, t)
    t["w"].add_(100.0)
    mgr.wait()
    assert_tree_equal(load_checkpoint(d, 1, like=tree()), tree())


def test_namedtuple_state_needs_like(tmp_path):
    init, _ = adamw(AdamWConfig())
    st = init({"w": torch.ones((3,))})
    d = str(tmp_path)
    save_checkpoint(d, 1, {"opt": st})
    with pytest.raises(ValueError):
        load_checkpoint(d, 1)  # no treedef, no like
    got = load_checkpoint(d, 1, like={"opt": st})
    assert type(got["opt"]).__name__ == "AdamWState" and int(got["opt"].step) == 0
    assert_tree_equal(got["opt"].m, st.m)


def test_chunked_large_leaf(tmp_path, monkeypatch):
    monkeypatch.setattr(TM, "_CHUNK_BYTES", 64)
    d = str(tmp_path)
    big = {"x": torch.arange(1000, dtype=torch.float32).reshape(100, 10)}
    TM.save_checkpoint(d, 1, big)
    manifest = json.load(open(os.path.join(d, "step_000000001", "manifest.json")))
    assert len(manifest["leaves"][0]["chunks"]) > 1 and manifest["treedef"] is None
    assert_tree_equal(TM.load_checkpoint(d, 1, like=big), big)


def test_bfloat16_leaves_refused(tmp_path):
    with pytest.raises(TypeError):
        save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2, dtype=torch.bfloat16)})


def test_wrong_like_refused(tmp_path):
    save_checkpoint(str(tmp_path), 1, tree())
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path), 1, like={"w": 0})


# ---------------------------------------------------------- across packages --
def _ref_tree():
    return {"w": jnp.arange(24.0).reshape(4, 6),
            "nested": {"b": jnp.ones((7,), jnp.int32), "scalar": jnp.asarray(2.5)},
            "list": [jnp.zeros((2, 2)), jnp.asarray(3, jnp.int32)]}


def _port_tree():
    return {"w": torch.arange(24.0).reshape(4, 6),
            "nested": {"b": torch.ones((7,), dtype=torch.int32), "scalar": torch.tensor(2.5)},
            "list": [torch.zeros((2, 2)), torch.tensor(3, dtype=torch.int32)]}


@pytest.mark.parametrize("codec", ["none", "zlib"])
@pytest.mark.parametrize("chunk", [None, 64])
def test_reference_checkpoint_loads_in_the_port(tmp_path, monkeypatch, codec, chunk):
    if chunk:
        monkeypatch.setattr(RM, "_CHUNK_BYTES", chunk)
    RM.save_checkpoint(str(tmp_path), 7, _ref_tree(), codec=codec)
    got = TM.load_checkpoint(str(tmp_path), 7, like=_port_tree())
    assert_tree_equal(got, jax.tree_util.tree_map(np.asarray, _ref_tree()))
    assert [np.asarray(x).dtype for x in tree_flatten(got)] == \
        [np.asarray(x).dtype for x in jax.tree_util.tree_leaves(_ref_tree())]


@pytest.mark.parametrize("codec", ["none", "zlib"])
@pytest.mark.parametrize("chunk", [None, 64])
def test_port_checkpoint_loads_in_the_reference(tmp_path, monkeypatch, codec, chunk):
    if chunk:
        monkeypatch.setattr(TM, "_CHUNK_BYTES", chunk)
    TM.save_checkpoint(str(tmp_path), 7, _port_tree(), codec=codec)
    got = RM.load_checkpoint(str(tmp_path), 7, like=_ref_tree())
    for a, b in zip(jax.tree_util.tree_leaves(got), tree_flatten(_port_tree())):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
    assert RM.latest_step(str(tmp_path)) == 7


def test_adamw_state_crosses_both_ways(tmp_path):
    """A {"params", "opt_state": AdamWState} tree, the trainers' checkpoint,
    written by each package and loaded by the other."""
    rng = np.random.default_rng(0)
    p = {"b": rng.normal(size=(3,)).astype(np.float32), "a": rng.normal(size=(2, 2)).astype(np.float32)}
    r_st = radamw(RAdamWConfig())[0]({k: jnp.asarray(v) for k, v in p.items()})
    r_st = r_st._replace(step=jnp.asarray(5, jnp.int32),
                         m={k: jnp.asarray(v * 2) for k, v in p.items()}, v={k: jnp.asarray(v * v) for k, v in p.items()})
    rtree = {"params": {k: jnp.asarray(v) for k, v in p.items()}, "opt_state": r_st}
    tparams = {k: torch.from_numpy(v) for k, v in p.items()}
    t_st = adamw(AdamWConfig())[0](tparams)
    t_st = t_st._replace(step=torch.tensor(5, dtype=torch.int32), m={k: v * 2 for k, v in tparams.items()},
                         v={k: v * v for k, v in tparams.items()})
    ttree = {"params": tparams, "opt_state": t_st}
    RM.save_checkpoint(str(tmp_path / "r"), 5, rtree)
    TM.save_checkpoint(str(tmp_path / "t"), 5, ttree)
    got_t = TM.load_checkpoint(str(tmp_path / "r"), 5, like=ttree)
    got_r = RM.load_checkpoint(str(tmp_path / "t"), 5, like=rtree)
    assert int(got_t["opt_state"].step) == int(got_r["opt_state"].step) == 5
    assert_tree_equal(got_t, ttree)
    for a, b in zip(jax.tree_util.tree_leaves(got_r), jax.tree_util.tree_leaves(rtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_manifests_match_the_references(tmp_path):
    RM.save_checkpoint(str(tmp_path / "r"), 2, _ref_tree(), codec="zlib")
    TM.save_checkpoint(str(tmp_path / "t"), 2, _port_tree(), codec="zlib")
    r = json.load(open(tmp_path / "r" / "step_000000002" / "manifest.json"))
    t = json.load(open(tmp_path / "t" / "step_000000002" / "manifest.json"))
    assert r["leaves"] == t["leaves"]
    assert sorted(os.listdir(tmp_path / "r" / "step_000000002")) == \
        sorted(os.listdir(tmp_path / "t" / "step_000000002"))


# ------------------------------------------- run_with_restarts, real manager --
def _acc_step(step, state):
    return {"acc": torch.as_tensor(state["acc"]) + torch.tensor(step + 1.0)}


@pytest.mark.parametrize("fail_at,restarts,resumed", [((7,), 1, [6]), ((3, 9), 2, [2, 8])])
def test_run_with_restarts_resumes_exactly_from_disk(tmp_path, fail_at, restarts, resumed):
    """`runtime/fault.py: run_with_restarts` with the port's
    CheckpointManager: faults mid-run resume from the last checkpoint on
    disk and the final state equals the no-fault run's, as the reference's
    `tests/test_fault.py` holds its own."""
    from repro_torch.runtime.fault import FaultInjector, run_with_restarts

    init = {"acc": torch.tensor(0.0)}
    want, _ = run_with_restarts(_acc_step, init, 10, CheckpointManager(str(tmp_path / "a"), keep=5),
                                checkpoint_every=2)
    got, log = run_with_restarts(_acc_step, init, 10, CheckpointManager(str(tmp_path / "b"), keep=5),
                                 checkpoint_every=2, injector=FaultInjector(fail_at_steps=fail_at))
    assert log["restarts"] == restarts and log["resumed_from"] == resumed
    assert float(got["acc"]) == float(want["acc"]) == 55.0


def test_restore_latest_without_a_saved_structure_refused(tmp_path):
    save_checkpoint(str(tmp_path), 1, tree())
    with pytest.raises(ValueError, match="like="):
        CheckpointManager(str(tmp_path)).restore_latest()
