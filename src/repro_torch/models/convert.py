"""Carry parameters between the reference and the port.

The reference's parameter tree for the dense family (`init_params` in
`repro/models/transformer.py`) as nested dicts of numpy arrays: `embed`
(padded_vocab, d_model), `final_norm`, `head` unless tied, and `layers`,
whose leaves are stacked over the layers on dim 0 (`attn_norm` (L, D),
`attn/wq` (L, D, H*Dh), ..., `ffn/w_down` (L, F, D)). The port's
`Transformer` keeps the same names and layout, so the mapping is a copy
per layer, cast to `cfg.dtype`.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Device, Transformer


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device: Device = None) -> Transformer:
    """The reference's parameter tree (numpy leaves) as the port's
    `Transformer` on `device` (CUDA when None), in `cfg.dtype`."""
    model = Transformer(cfg, device)

    def put(p: torch.Tensor, a) -> None:
        a = np.array(a, dtype=np.float32)
        if a.shape != tuple(p.shape):
            raise ValueError(f"parameter of shape {a.shape} where {tuple(p.shape)} is expected")
        p.copy_(torch.from_numpy(a))

    with torch.no_grad():
        for name, p in model.params().items():
            put(p, tree[name])
        stacked = tree["layers"]
        for i, blk in enumerate(model.layers):
            for name, p in blk.params().items():
                put(p, stacked[name][i])
            for sub in ("attn", "ffn"):
                for name, p in getattr(blk, sub).params().items():
                    put(p, stacked[sub][name][i])
    return model


def params_to_numpy(model: Transformer) -> Dict[str, Any]:
    """The inverse of `params_from_numpy`: float32 numpy leaves, the layer
    leaves stacked on dim 0."""
    def arr(p: torch.Tensor) -> np.ndarray:
        return p.detach().to(torch.float32).cpu().numpy()

    tree: Dict[str, Any] = {name: arr(p) for name, p in model.params().items()}
    blocks = list(model.layers)
    layers_tree: Dict[str, Any] = {
        name: np.stack([arr(b.params()[name]) for b in blocks]) for name in blocks[0].params()
    }
    for sub in ("attn", "ffn"):
        mods = [getattr(b, sub) for b in blocks]
        layers_tree[sub] = {name: np.stack([arr(m.params()[name]) for m in mods])
                            for name in mods[0].params()}
    tree["layers"] = layers_tree
    return tree
