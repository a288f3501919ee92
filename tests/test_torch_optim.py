"""The port's AdamW and LR schedules (`repro_torch.optim`) against the
reference's (`repro.optim`, its update run under `jax.jit` as its train
step runs it), and the reference's own checks (`tests/test_optim.py`)
mirrored.

Tolerances (float32): the update and the parameters after it 1e-6
relative plus 1e-8 absolute per element (the same operations in the same
order; `np.float32` powers and cosines against XLA's may differ by an
ulp); m and v 1e-5 relative (XLA may fuse a moment's multiply and add
into one FMA: measured 1.6e-6 on one element of 24); grad_norm 1e-6
relative (leaf sums in another order); the schedules 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as RConfig
from repro.optim import adamw as radamw
from repro.optim import warmup_cosine as rwarmup
from repro.optim.adamw import apply_updates as rapply
from repro.optim.adamw import clip_by_global_norm as rclip
from repro.optim.schedules import constant as rconstant
from repro_torch.optim import AdamWConfig, adamw, warmup_cosine
from repro_torch.optim.adamw import apply_updates, apply_updates_, clip_by_global_norm, global_norm
from repro_torch.optim.schedules import constant

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_adamw_matches_reference_impl():
    """One leaf, no decay/clip: against the textbook update."""
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0, clip_norm=None)
    init, update = adamw(cfg)
    p = {"w": _t([1.0, -2.0, 3.0])}
    st = init(p)
    g = {"w": _t([0.5, 0.1, -0.2])}
    m = v = np.zeros(3)
    w = np.array([1.0, -2.0, 3.0])
    for t in range(1, 4):
        upd, st, _ = update(g, st, p)
        p = apply_updates(p, upd)
        gnp = np.array([0.5, 0.1, -0.2])
        m = 0.9 * m + 0.1 * gnp
        v = 0.99 * v + 0.01 * gnp * gnp
        mh, vh = m / (1 - 0.9 ** t), v / (1 - 0.99 ** t)
        w = w - 0.1 * mh / (np.sqrt(vh) + 1e-8)
        np.testing.assert_allclose(p["w"].numpy(), w, rtol=1e-5)


def test_weight_decay_decoupled():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, clip_norm=None)
    init, update = adamw(cfg)
    p = {"w": _t([2.0])}
    upd, _, _ = update({"w": _t([0.0])}, init(p), p)
    np.testing.assert_allclose(float(upd["w"][0]), -0.1 * 0.5 * 2.0, rtol=1e-6)


def test_clip_by_global_norm():
    tree = {"a": _t([3.0, 0.0]), "b": _t([0.0, 4.0])}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    np.testing.assert_allclose(float(norm), 5.0, rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)
    same, _ = clip_by_global_norm(tree, 10.0)
    np.testing.assert_allclose(same["a"].numpy(), tree["a"].numpy())


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 7.0])
def test_clip_matches_reference(max_norm):
    rng = np.random.default_rng(int(max_norm * 10))
    tree = {k: rng.normal(size=s).astype(np.float32) for k, s in (("a", (5, 3)), ("b", (7,)), ("c", ()))}
    want, wnorm = rclip({k: jnp.asarray(v) for k, v in tree.items()}, max_norm)
    got, norm = clip_by_global_norm({k: _t(v) for k, v in tree.items()}, max_norm)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-8)


def test_warmup_cosine_shape():
    s = warmup_cosine(10, 100, final_frac=0.1)
    assert float(s(0)) == 0.0
    np.testing.assert_allclose(float(s(10)), 1.0, rtol=1e-5)
    assert float(s(5)) == 0.5
    np.testing.assert_allclose(float(s(100)), 0.1, atol=1e-5)
    vals = [float(s(t)) for t in range(10, 101, 10)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))


@pytest.mark.parametrize("warm,total,frac", [(10, 100, 0.1), (2, 8, 0.1), (0, 5, 0.0), (3, 3, 0.5)])
def test_schedules_match_reference(warm, total, frac):
    rs, ts = rwarmup(warm, total, frac), warmup_cosine(warm, total, frac)
    for step in range(0, total + 3):
        np.testing.assert_allclose(float(ts(step)), float(rs(jnp.asarray(step))), rtol=1e-6, atol=1e-7)
    assert float(constant()(7)) == float(rconstant()(jnp.asarray(7))) == 1.0


def test_adamw_converges_on_quadratic():
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0)
    init, update = adamw(cfg)
    p = {"w": _t([5.0, -3.0])}
    st = init(p)
    target = _t([1.0, 2.0])
    for _ in range(300):
        g = {"w": 2 * (p["w"] - target)}
        upd, st, _ = update(g, st, p)
        p = apply_updates(p, upd)
    assert float(torch.sum((p["w"] - target) ** 2)) < 1e-3


@pytest.mark.parametrize("clip,wd,sched", [(1.0, 0.1, True), (None, 0.0, False), (0.01, 0.3, True)])
def test_adamw_steps_match_reference(clip, wd, sched):
    """Five steps on three leaves against the reference's jitted update:
    the updates, the parameters, m, v, grad_norm and lr."""
    rng = np.random.default_rng(11)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in (("a", (6, 4)), ("b", (9,)), ("c", (2, 3, 2)))}
    grads = [{k: rng.normal(0, 0.3, v.shape).astype(np.float32) for k, v in p0.items()} for _ in range(5)]
    kw = dict(lr=3e-3, weight_decay=wd, clip_norm=clip)
    ri, ru = radamw(RConfig(schedule=rwarmup(2, 5) if sched else None, **kw))
    ti, tu = adamw(AdamWConfig(schedule=warmup_cosine(2, 5) if sched else None, **kw))
    ru = jax.jit(ru)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: _t(v) for k, v in p0.items()}
    rs, ts = ri(rp), ti(tp)
    for g in grads:
        rupd, rs, rm = ru({k: jnp.asarray(v) for k, v in g.items()}, rs, rp)
        tupd, ts, tm = tu({k: _t(v) for k, v in g.items()}, ts, tp)
        rp = rapply(rp, rupd)
        apply_updates_(tp, tupd)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(rm["lr"]), rtol=1e-6)
        for k in p0:
            np.testing.assert_allclose(tupd[k].numpy(), np.asarray(rupd[k]), rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]), rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(rs.m[k]), rtol=1e-5, atol=1e-9)
            np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(rs.v[k]), rtol=1e-5, atol=1e-12)
    assert int(ts.step) == int(rs.step) == 5


def test_state_is_float32_and_updated_in_place():
    init, update = adamw(AdamWConfig())
    p = {"w": torch.ones(4)}
    st = init(p)
    m = st.m["w"]
    _, st2, _ = update({"w": torch.full((4,), 0.5)}, st, p)
    assert st2.m["w"] is m and m.dtype == torch.float32 and float(m[0]) != 0.0
    assert st2.step.dtype == torch.int32 and int(st2.step) == 1
