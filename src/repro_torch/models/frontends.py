"""Modality front-end stubs for the audio and vision architectures (port of
`repro/models/frontends.py`).

musicgen-large and pixtral-12b run their transformer backbone on
`(B, S, d_model)` embeddings (`cfg.input_kind == "embeddings"`); these
stubs make such embeddings end to end:
  * audio, MusicGen-style: EnCodec codes int (B, S, n_codebooks) -> the sum
    of one embedding row per codebook (4 codebooks of 2,048 entries in
    MusicGen, arXiv:2306.05284);
  * vision, Pixtral-style: flattened patch pixels (B, S, patch_dim) -> a
    linear projection (16 x 16 RGB patches, patch_dim 768, in
    hf:mistralai/Pixtral-12B-2409's `vision_config`).
Plain tensor functions: no kernel (the reference's are jnp). Parameters are
drawn from an explicit `torch.Generator` with the reference's
distributions, not its numbers; `convert.frontend_params_from_numpy`
carries the reference's own across.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.core.device import DeviceLike, resolve_device

#: MusicGen's EnCodec: codebooks and entries per codebook
AUDIO_CODEBOOKS, AUDIO_CODEBOOK_SIZE = 4, 2048
#: Pixtral's vision patches: 16 x 16 pixels x 3 channels
VISION_PATCH_DIM = 16 * 16 * 3


def _normal(shape, scale: float, dtype: torch.dtype, generator: Optional[torch.Generator],
            device: torch.device) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


def init_audio_frontend(n_codebooks: int, codebook_size: int, d_model: int,
                        dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None,
                        device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """`{"codebooks": (n_codebooks, codebook_size, d_model)}`, each entry
    N(0, 1) / sqrt(d_model), drawn in float32 on `device` (CUDA when None)
    and held in `dtype`."""
    device = resolve_device(device)
    return {"codebooks": _normal((n_codebooks, codebook_size, d_model), 1.0 / math.sqrt(d_model), dtype,
                                 generator, device)}


def audio_frames_to_embeddings(params: Dict[str, torch.Tensor], codes: torch.Tensor) -> torch.Tensor:
    """codes int (B, S, n_codebooks) -> (B, S, d_model): codebook i's row of
    code i, summed in codebook order from the first (the reference's
    `sum(embs)`), in the codebooks' dtype."""
    books = params["codebooks"]
    codes = codes.long()
    out = books[0][codes[..., 0]]
    for i in range(1, codes.shape[-1]):
        out = out + books[i][codes[..., i]]
    return out


def init_vision_frontend(patch_dim: int, d_model: int, dtype: torch.dtype = torch.float32,
                         generator: Optional[torch.Generator] = None,
                         device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """`{"proj": (patch_dim, d_model)}`, N(0, 1) / sqrt(patch_dim) (the
    reference's `init_dense`), drawn in float32 on `device` (CUDA when
    None) and held in `dtype`."""
    device = resolve_device(device)
    return {"proj": _normal((patch_dim, d_model), 1.0 / math.sqrt(patch_dim), dtype, generator, device)}


def patches_to_embeddings(params: Dict[str, torch.Tensor], patches: torch.Tensor) -> torch.Tensor:
    """patches (B, S, patch_dim) -> (B, S, d_model): `patches @ proj`."""
    return patches @ params["proj"]
