"""Carry parameters between the reference and the port.

The reference's parameter tree (`init_params` in
`repro/models/transformer.py`) as nested dicts of numpy arrays: `embed`
(padded_vocab, d_model), `final_norm`, `head` unless tied, and the stacked
blocks: `layers` for the dense, moe and ssm families, `groups` and `tail`
for the hybrid family, whose leaves are stacked over the blocks on dim 0
(`layers/attn/wq` (L, D, H*Dh), ..., `groups/rec1/rglru/w_in_x` (G, D, R),
`tail/ffn/w_down` (T, F, D)). The port's `Transformer` keeps the same names
and layout, one module per block, so a parameter `layers.<i>.attn.wq` is
row i of the tree's `layers/attn/wq`, and `groups.<i>.rec1.rglru.lam` row
i of `groups/rec1/rglru/lam`.

`named_to_tree` and `tree_to_named` map any dict keyed by the port's
parameter names (the parameters, or AdamW's `m` and `v`) to and from that
tree; the checkpoints of `launch/train.py` are written in it, so that
either package can resume from the other's. `frontend_params_from_numpy`
carries the reference's front-end stubs (`models/frontends.py`) across.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Device, Transformer

#: the subtrees whose leaves are stacked over blocks on dim 0
STACKS = ("layers", "groups", "tail")


def named_to_tree(named: Mapping[str, Any]) -> Dict[str, Any]:
    """{port parameter name: leaf} -> the reference's nested tree, the
    per-block leaves stacked on dim 0 (`np.stack` of numpy leaves,
    `torch.stack` of tensors)."""
    tree: Dict[str, Any] = {}
    per_block: Dict[tuple, list] = {}
    for name, leaf in named.items():
        parts = name.split(".")
        if parts[0] in STACKS:
            per_block.setdefault((parts[0], ".".join(parts[2:])), []).append((int(parts[1]), leaf))
        else:
            tree[name] = leaf
    for (stack, rest), rows in per_block.items():
        leaves = [leaf for _, leaf in sorted(rows, key=lambda r: r[0])]
        stacked = torch.stack(leaves) if isinstance(leaves[0], torch.Tensor) else np.stack(leaves)
        node = tree.setdefault(stack, {})
        *path, last = rest.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = stacked
    return tree


def tree_to_named(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of `named_to_tree`: the stacked leaves split into rows
    (views), keyed by the port's parameter names."""
    named: Dict[str, Any] = {k: v for k, v in tree.items() if k not in STACKS}

    def walk(stack: str, node: Mapping[str, Any], prefix: str) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(stack, val, f"{prefix}{key}.")
            else:
                for i in range(val.shape[0]):
                    named[f"{stack}.{i}.{prefix}{key}"] = val[i]

    for stack in STACKS:
        walk(stack, tree.get(stack, {}), "")
    return named


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device: Device = None,
                      param_dtype: Optional[str] = None) -> Transformer:
    """The reference's parameter tree (numpy leaves) as the port's
    `Transformer` on `device` (CUDA when None), held as
    `Transformer(..., param_dtype)` holds it: in `cfg.dtype` to serve, as
    float32 masters to train."""
    model = Transformer(cfg, device, param_dtype)
    named = tree_to_named(tree)
    with torch.no_grad():
        for name, p in model.named_parameters():
            a = np.array(named[name], dtype=np.float32)
            if a.shape != tuple(p.shape):
                raise ValueError(f"{name}: parameter of shape {a.shape} where {tuple(p.shape)} is expected")
            p.copy_(torch.from_numpy(a))
    return model


def frontend_params_from_numpy(tree: Mapping[str, Any], dtype: torch.dtype = torch.float32,
                               device: Device = None) -> Dict[str, torch.Tensor]:
    """The reference's front-end parameters (`init_audio_frontend`'s
    `{"codebooks"}` or `init_vision_frontend`'s `{"proj"}`, numpy leaves) as
    the tensors of `models/frontends.py`, in `dtype` on `device` (CUDA when
    None)."""
    device = resolve_device(device)
    return {name: torch.from_numpy(np.array(leaf, dtype=np.float32)).to(device=device, dtype=dtype)
            for name, leaf in tree.items()}


def params_to_numpy(model: Transformer) -> Dict[str, Any]:
    """The inverse of `params_from_numpy`: float32 numpy leaves, the block
    leaves stacked on dim 0."""
    return named_to_tree({name: p.detach().to(torch.float32).cpu().numpy()
                          for name, p in model.named_parameters()})
