"""End-to-end trainer (port of `repro/launch/train.py`).

Wires the pieces together: --arch config (reduced or full), the
CStream-compressed data feed (`data/pipeline.py`, decoded on the device by
kernel B2), AdamW, the microbatched train step (`launch/steps.py`; the
forward runs kernel B10 with its log-sum-exp, the backward the flash
backward under full remat), async atomic checkpointing, heartbeat and
straggler monitoring, fault-injection drills and exact resume.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --full \\
      --steps 8 --batch 4 --seq 1024                  # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
      --steps 20 --batch 8 --seq 128 --device cpu --checkpoint-dir /tmp/ckpt

`train(mesh=...)` trains data-parallel on a port `DeviceMesh` under the
active logical mapping (`models/partition.py`): masters and AdamW moments
held as shards by `sharding.param_specs(cfg, "train")`, the global batch
split over the data axes, the compressed sync over the pod axis when
`grad_compression` is given (`launch/steps.py: _mesh_train_step`); the
dense and moe families split their compute over a model axis of several
slots (tensor parallelism, one group program per data shard).

Checkpoints hold {"params", "opt_state": AdamWState(step, m, v)} in the
reference's tree (`models/convert.py: named_to_tree`, layers stacked on dim
0, float32), so the reference's trainer can resume from the port's and the
port's from the reference's. Weights start random from `seed` (a torch
generator: not the reference's numbers).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.core.gradient import GradCompressionConfig
from repro_torch.core.device import DeviceLike, resolve_device, synchronize
from repro_torch.data.pipeline import CompressedFeed, zipf_token_stream
from repro_torch.launch.steps import TrainStepConfig, make_train_step, microbatch_split
from repro_torch.models import partition
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import named_to_tree, tree_to_named
from repro_torch.models.transformer import Transformer
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime.elastic import logical_mapping
from repro_torch.runtime.fault import FaultInjector, HeartbeatMonitor, StragglerDetector
from repro_torch.runtime.sharding import Sharded, param_specs, physical_specs


@dataclasses.dataclass
class TrainRun:
    losses: list
    wall_s: float
    tokens_per_s: float
    feed_ratio: float
    restarts: int
    stragglers: int
    final_step: int
    #: each step's wall time in seconds, the train step alone, synchronized
    #: (port-only, for the chip run's report)
    step_s: list = dataclasses.field(default_factory=list)


def _named(model) -> Dict[str, Any]:
    """{name: parameter} of a `Transformer`, or the data-parallel step's
    {name: `Sharded`} itself."""
    return model if isinstance(model, dict) else dict(model.named_parameters())


def state_tree(model, opt_state: AdamWState) -> Dict[str, Any]:
    """The training state as the reference's checkpoint tree, host tensors
    (copies of device ones; sharded leaves gathered whole)."""
    def tree(named) -> Dict[str, Any]:
        return named_to_tree({k: (t.gather() if isinstance(t, Sharded) else t).detach().cpu()
                              for k, t in named.items()})

    return {"params": tree(_named(model)),
            "opt_state": AdamWState(step=opt_state.step.cpu(), m=tree(opt_state.m), v=tree(opt_state.v))}


def state_like(model) -> Dict[str, Any]:
    """`state_tree`'s structure, for `load_checkpoint(like=...)`."""
    def tree() -> Dict[str, Any]:
        return named_to_tree({k: np.zeros(1) for k in _named(model)})

    return {"params": tree(), "opt_state": AdamWState(step=np.zeros(()), m=tree(), v=tree())}


def restore_state(model, got: Dict[str, Any], opt_state: Optional[AdamWState] = None) -> AdamWState:
    """Copy a loaded `state_tree` (numpy leaves) into `model`'s parameters
    in place; returns the optimizer state on the model's device. Sharded
    state (`model` a {name: `Sharded`}) is written into its shards, the
    moments into `opt_state`'s."""
    if isinstance(model, dict):
        st = got["opt_state"]
        for mine, tree in ((model, got["params"]), (opt_state.m, st.m), (opt_state.v, st.v)):
            for k, a in tree_to_named(tree).items():
                mine[k].write(torch.from_numpy(np.ascontiguousarray(a)))
        return AdamWState(step=torch.tensor(int(np.asarray(st.step)), dtype=torch.int32),
                          m=opt_state.m, v=opt_state.v)
    dev = model.device

    def named(tree) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for k, a in tree_to_named(tree).items()}

    params = named(got["params"])
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])
    st = got["opt_state"]
    return AdamWState(step=torch.tensor(int(np.asarray(st.step)), dtype=torch.int32),
                      m=named(st.m), v=named(st.v))


def train(
    cfg: ModelConfig,
    steps: int = 20,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    microbatches: int = 1,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 10,
    resume: bool = False,
    fail_at: tuple = (),
    seed: int = 0,
    codec: str = "delta_leb128",
    log_every: int = 10,
    device: DeviceLike = None,
    mesh=None,
    grad_compression: Optional[GradCompressionConfig] = None,
) -> TrainRun:
    """Train `cfg` for `steps` steps on a Zipf token stream, on `device`
    (CUDA when None). An injected fault at a step of `fail_at` restarts
    from the latest committed checkpoint (or from the start without one).
    With `mesh`, data-parallel over its slots (see the module's docstring);
    the feed decodes on `device`."""
    device = resolve_device(device)
    opt_cfg = AdamWConfig(lr=lr, schedule=warmup_cosine(max(steps // 20, 2), steps))
    pspecs = None
    if mesh is not None:
        with partition.logical_axes(partition.current_axes() or logical_mapping(mesh.axis_names)):
            pspecs = physical_specs(param_specs(cfg, "train"))
    step_cfg = TrainStepConfig(microbatches=microbatches, grad_compression=grad_compression)
    init_fn, train_step = make_train_step(cfg, opt_cfg, step_cfg, mesh=mesh, param_pspecs=pspecs,
                                          device=device)
    feed = CompressedFeed(zipf_token_stream(cfg.vocab_size, batch, seq, seed=seed), codec=codec,
                          device=device).start()

    model, opt_state = init_fn(seed)
    start_step = 0
    mgr = CheckpointManager(checkpoint_dir, keep=3) if checkpoint_dir else None
    like = state_like(model)
    if mgr and resume:
        got_step, got = mgr.restore_latest(like=like)
        if got is not None:
            opt_state = restore_state(model, got, opt_state)
            # step counter is authoritative from the optimizer state
            start_step = int(opt_state.step)
            print(f"[train] resumed from checkpoint at step {start_step}")

    hb = HeartbeatMonitor(timeout_s=600).start()
    strag = StragglerDetector()
    injector = FaultInjector(fail_at_steps=tuple(fail_at))
    losses: List[float] = []
    step_s: List[float] = []
    restarts = 0
    t0 = time.perf_counter()
    step = start_step
    try:
        while step < steps:
            try:
                batch_arrays = microbatch_split(feed.next_batch(), microbatches)
                injector.maybe_fail(step)
                ts = time.perf_counter()
                model, opt_state, metrics = train_step(model, opt_state, batch_arrays)
                loss = float(metrics["loss"])
                synchronize(device)
                dt = time.perf_counter() - ts
                hb.beat()
                strag.record(step, dt)
                losses.append(loss)
                step_s.append(dt)
                if step % log_every == 0:
                    print(f"[train] step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")
                step += 1
                if mgr and step % checkpoint_every == 0:
                    mgr.save_async(step, state_tree(model, opt_state))
            except RuntimeError as e:
                if "injected" not in str(e) or mgr is None:
                    raise
                restarts += 1
                mgr.wait()
                got_step, got = mgr.restore_latest(like=like)
                if got is None:
                    model, opt_state = init_fn(seed)
                    step = 0
                else:
                    opt_state = restore_state(model, got, opt_state)
                    step = int(opt_state.step)
                print(f"[train] restart #{restarts}: resumed at step {step}")
        wall = time.perf_counter() - t0
        if mgr:
            mgr.save_async(step, state_tree(model, opt_state))
            mgr.wait()
    finally:
        hb.stop()
        feed.stop()
    tokens = (step - start_step) * batch * seq
    return TrainRun(
        losses=losses,
        wall_s=wall,
        tokens_per_s=tokens / max(wall, 1e-9),
        feed_ratio=feed.stats.ratio,
        restarts=restarts,
        stragglers=len(strag.events),
        final_step=step,
        step_s=step_s,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--codec", default="delta_leb128")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    cfg = spec.model.reduced() if args.reduced else spec.model
    run = train(
        cfg,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        lr=args.lr,
        microbatches=args.microbatches,
        checkpoint_dir=args.checkpoint_dir,
        resume=args.resume,
        fail_at=tuple(args.fail_at),
        codec=args.codec,
        device=args.device,
    )
    print(json.dumps({
        "arch": args.arch,
        "final_loss": run.losses[-1] if run.losses else None,
        "first_loss": run.losses[0] if run.losses else None,
        "tokens_per_s": round(run.tokens_per_s, 1),
        "feed_compression_ratio": round(run.feed_ratio, 3),
        "restarts": run.restarts,
        "stragglers": run.stragglers,
        "final_step": run.final_step,
    }, indent=1))


if __name__ == "__main__":
    main()
