"""Parameter storage for the model modules: `Storage` (where and in what
dtype a model's parameters live) and `_Params`, the base of every module
whose parameters carry the reference's names (`models/transformer.py`,
`models/moe.py`)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class Storage:
    """Where and how a model's parameters are held: `param` dtype on
    `device`, with gradients when `train`; functions compute in
    `compute` (cfg.dtype)."""

    compute: torch.dtype
    param: torch.dtype
    device: torch.device
    train: bool


class _Params(nn.Module):
    """A module whose own parameters carry the reference's names; `params()`
    maps them, in the compute dtype, for the functions of
    `models/layers.py` and `models/moe.py`."""

    def __init__(self, store: Storage):
        super().__init__()
        self._store = store

    def _add(self, name: str, shape) -> None:
        st = self._store
        self.register_parameter(name, nn.Parameter(
            torch.zeros(shape, dtype=st.param, device=st.device), requires_grad=st.train))

    def p(self, name: str) -> torch.Tensor:
        """Parameter `name` in the compute dtype (itself when it is held so)."""
        t = getattr(self, name)
        return t if t.dtype == self._store.compute else t.to(self._store.compute)

    def params(self) -> Dict[str, torch.Tensor]:
        return {name: self.p(name) for name, _ in self.named_parameters(recurse=False)}
