"""Carry parameters between the reference and the port.

The reference's parameter tree for the dense family (`init_params` in
`repro/models/transformer.py`) as nested dicts of numpy arrays: `embed`
(padded_vocab, d_model), `final_norm`, `head` unless tied, and `layers`,
whose leaves are stacked over the layers on dim 0 (`attn_norm` (L, D),
`attn/wq` (L, D, H*Dh), ..., `ffn/w_down` (L, F, D)). The port's
`Transformer` keeps the same names and layout, one module per layer, so a
parameter `layers.<i>.attn.wq` is row i of the tree's `layers/attn/wq`.

`named_to_tree` and `tree_to_named` map any dict keyed by the port's
parameter names (the parameters, or AdamW's `m` and `v`) to and from that
tree; the checkpoints of `launch/train.py` are written in it, so that
either package can resume from the other's.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Device, Transformer


def named_to_tree(named: Mapping[str, Any]) -> Dict[str, Any]:
    """{port parameter name: leaf} -> the reference's nested tree, the
    per-layer leaves stacked on dim 0 (`np.stack` of numpy leaves,
    `torch.stack` of tensors)."""
    tree: Dict[str, Any] = {}
    per_layer: Dict[str, list] = {}
    for name, leaf in named.items():
        parts = name.split(".")
        if parts[0] == "layers":
            per_layer.setdefault(".".join(parts[2:]), []).append((int(parts[1]), leaf))
        else:
            tree[name] = leaf
    layers: Dict[str, Any] = {}
    for rest, rows in per_layer.items():
        leaves = [leaf for _, leaf in sorted(rows, key=lambda r: r[0])]
        stacked = torch.stack(leaves) if isinstance(leaves[0], torch.Tensor) else np.stack(leaves)
        node = layers
        *path, last = rest.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = stacked
    if layers:
        tree["layers"] = layers
    return tree


def tree_to_named(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of `named_to_tree`: the stacked layer leaves split into
    rows (views), keyed by the port's parameter names."""
    named: Dict[str, Any] = {k: v for k, v in tree.items() if k != "layers"}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.")
            else:
                for i in range(val.shape[0]):
                    named[f"layers.{i}.{prefix}{key}"] = val[i]

    walk(tree.get("layers", {}), "")
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


def params_to_numpy(model: Transformer) -> Dict[str, Any]:
    """The inverse of `params_from_numpy`: float32 numpy leaves, the layer
    leaves stacked on dim 0."""
    return named_to_tree({name: p.detach().to(torch.float32).cpu().numpy()
                          for name, p in model.named_parameters()})
