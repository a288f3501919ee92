"""AdamW from scratch (port of `repro/optim/adamw.py`): decoupled weight
decay, global-norm clipping, schedule-driven LR.

Plain functions over dicts of float32 tensors keyed like the parameters
(`dict(model.named_parameters())`), with the reference's arithmetic and
order of operations: bias correction at the step as float32, the decay
added inside the update before `-lr`. (`torch.optim.AdamW` orders them
otherwise.) `update_fn` updates the state's `m` and `v` in place and
returns the updates as new tensors; `apply_updates_` adds them to the
parameters in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

Tree = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    #: step -> LR multiplier (`optim/schedules.py`)
    schedule: Optional[Callable[[int], float]] = None


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 [] (on the CPU)
    m: Dict[str, torch.Tensor]  # float32, keyed like the parameters
    v: Dict[str, torch.Tensor]


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, float32."""
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(tree scaled by min(1, max_norm / max(norm, 1e-12)), norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in tree.items()}, norm


def _f32(x) -> float:
    return float(np.float32(x))


def adamw(cfg: AdamWConfig):
    """Returns (init_fn, update_fn).

    update_fn(grads, state, params) -> (updates, new_state, {"grad_norm",
    "lr"}); `updates` are the deltas to ADD to the parameters (already
    scaled by -lr), the optax convention, as the reference's."""

    def init_fn(params: Tree) -> AdamWState:
        zeros = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          m=zeros, v={k: torch.zeros_like(z) for k, z in zeros.items()})

    def update_fn(grads: Tree, state: AdamWState, params: Tree):
        step = int(state.step) + 1
        if cfg.clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        else:
            gnorm = global_norm(grads)
        lr = np.float32(cfg.lr) * np.float32(cfg.schedule(step) if cfg.schedule is not None else 1.0)
        t = np.float32(step)
        bc1 = _f32(np.float32(1) - np.float32(cfg.b1) ** t)
        bc2 = _f32(np.float32(1) - np.float32(cfg.b2) ** t)
        keys = list(grads)
        g32 = [grads[k].to(torch.float32) for k in keys]
        m = [state.m[k] for k in keys]
        v = [state.v[k] for k in keys]
        # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
        torch._foreach_mul_(m, _f32(cfg.b1))
        torch._foreach_add_(m, torch._foreach_mul(g32, _f32(1 - cfg.b1)))
        torch._foreach_mul_(v, _f32(cfg.b2))
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g32, _f32(1 - cfg.b2)), g32))
        del g32
        # delta = -lr (mhat / (sqrt(vhat) + eps) + wd p)
        mhat = torch._foreach_div(m, bc1)
        den = torch._foreach_sqrt(torch._foreach_div(v, bc2))
        torch._foreach_add_(den, _f32(cfg.eps))
        torch._foreach_div_(mhat, den)
        del den
        torch._foreach_add_(mhat, torch._foreach_mul([params[k].to(torch.float32) for k in keys],
                                                     _f32(cfg.weight_decay)))
        torch._foreach_mul_(mhat, _f32(-lr))
        updates = {k: d.to(params[k].dtype) for k, d in zip(keys, mhat)}
        new_state = AdamWState(step=torch.tensor(step, dtype=torch.int32), m=state.m, v=state.v)
        return updates, new_state, {"grad_norm": gnorm, "lr": float(lr)}

    return init_fn, update_fn


def apply_updates(params: Tree, updates: Tree) -> Dict[str, torch.Tensor]:
    """params + updates, as new tensors."""
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def apply_updates_(params: Tree, updates: Tree) -> None:
    """params += updates, in place."""
    keys = list(params)
    torch._foreach_add_([params[k] for k in keys], [updates[k].to(params[k].dtype) for k in keys])
