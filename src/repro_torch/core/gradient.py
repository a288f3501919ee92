"""Error-feedback compressed gradient synchronization (port of
`repro/core/gradient.py`).

CStream's lossy NUQ codec at the data-parallel boundary: the gradients
that cross a mesh axis travel as uint8/uint4 mu-law codes plus per-chunk
absmax scales instead of float32. Error feedback keeps the quantization
residual and re-injects it at the next step (the analogue of ADPCM's
reconstruction carried in the state, paper §3.1.2).

  quantize_tensor / dequantize_tensor  — chunked absmax mu-law codec, on
                                          the mu-law tables the port builds
                                          on the host (`core/algorithms/
                                          nuq.py`, ROADMAP C2): the codes
                                          are the jitted reference's
  compressed_allreduce_mean            — one tensor per mesh slot: each
                                          slot's codes and scales go to
                                          every slot, which dequantizes and
                                          averages (the gather form of the
                                          reference's collective)
  compressed_grad_sync                 — that over every leaf of a
                                          gradient dict, across one axis of
                                          a `runtime/elastic.DeviceMesh`
  ef_init / ef_step                    — error-feedback state

No kernel: the reference quantizes in jnp (`nuq.mulaw_encode_unsigned`),
with no Pallas twin. Gradient trees are dicts of tensors (nested dicts
allowed).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.algorithms.nuq import mulaw_decode_unsigned, mulaw_encode_unsigned


@dataclasses.dataclass(frozen=True)
class GradCompressionConfig:
    qbits: int = 8  # 8 (uint8) or 4 (packed pairs)
    chunk: int = 2048  # values per absmax scale
    error_feedback: bool = True
    mu: float = 255.0


def _map(fn: Callable, *trees):
    """`fn` over the leaves of dicts of one structure (nested dicts allowed)."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


# ------------------------------------------------------------ leaf codec --
def quantize_tensor(x: torch.Tensor, cfg: GradCompressionConfig) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """x (any shape) -> (codes uint8[ceil(n*qbits/8)], scales float32
    [n_chunks], n), on x's device."""
    if cfg.qbits not in (4, 8):
        raise ValueError(f"qbits must be 4 or 8, got {cfg.qbits}")
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    flat = torch.nn.functional.pad(flat, (0, (-n) % cfg.chunk))
    ch = flat.reshape(-1, cfg.chunk)
    scale = torch.amax(torch.abs(ch), dim=1) + 1e-12
    xn = ch / scale[:, None]
    sign = (xn < 0).to(torch.int32)
    mag = mulaw_encode_unsigned(torch.abs(xn), cfg.qbits - 1, 1.0, cfg.mu)
    codes = ((sign << (cfg.qbits - 1)) | mag).reshape(-1).to(torch.uint8)
    if cfg.qbits == 4:
        codes = codes[0::2] | (codes[1::2] << 4)
    return codes, scale, n


def dequantize_tensor(packed: torch.Tensor, scale: torch.Tensor, n: int, shape,
                      cfg: GradCompressionConfig, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if cfg.qbits == 8:
        codes = packed.to(torch.int32)
    else:
        lo = (packed & 0x0F).to(torch.int32)
        hi = (packed >> 4).to(torch.int32)
        codes = torch.stack([lo, hi], dim=1).reshape(-1)
    sign = (codes >> (cfg.qbits - 1)) & 1
    mag = mulaw_decode_unsigned(codes & ((1 << (cfg.qbits - 1)) - 1), cfg.qbits - 1, 1.0, cfg.mu,
                                round_int=False)
    xn = torch.where(sign == 1, -mag, mag).reshape(-1, cfg.chunk)
    flat = (xn * scale[:, None]).reshape(-1)[:n]
    return flat.reshape(shape).to(dtype)


def roundtrip(x: torch.Tensor, cfg: GradCompressionConfig) -> torch.Tensor:
    packed, scale, n = quantize_tensor(x, cfg)
    return dequantize_tensor(packed, scale, n, x.shape, cfg, x.dtype)


def wire_bytes(x: torch.Tensor, cfg: GradCompressionConfig) -> int:
    """Bytes on the wire for one tensor (codes + scales)."""
    n = x.numel()
    pad_n = n + ((-n) % cfg.chunk)
    return pad_n * cfg.qbits // 8 + (pad_n // cfg.chunk) * 4


# ------------------------------------------------------------ collective --
def compressed_allreduce_mean(xs: Sequence[torch.Tensor], cfg: GradCompressionConfig,
                              devices: Optional[Sequence[torch.device]] = None) -> List[torch.Tensor]:
    """The mean of one tensor per slot, the codes on the wire: each slot
    quantizes its own tensor, every slot receives all slots' codes and
    scales (on `devices[i]`, default each tensor's own), dequantizes them
    and averages. Returns one result per slot, on its device."""
    devices = [x.device for x in xs] if devices is None else [torch.device(d) for d in devices]
    shape, dtype = xs[0].shape, xs[0].dtype
    sent = [quantize_tensor(x.to(d), cfg) for x, d in zip(xs, devices)]
    out = []
    for d in devices:
        deq = torch.stack([dequantize_tensor(p.to(d), s.to(d), n, shape, cfg) for p, s, n in sent])
        out.append(torch.mean(deq, dim=0).to(dtype))
    return out


def compressed_grad_sync(grads: Any, mesh, axis: str = "pod",
                         cfg: GradCompressionConfig = GradCompressionConfig(),
                         param_specs: Optional[Any] = None):
    """Synchronize gradients across the `axis` of a port `DeviceMesh`
    (`runtime/elastic.py`) with compression: `grads` is one gradient dict
    per slot of the axis (a single dict for an axis of one slot, returned
    as a single dict), each on its slot's device; every slot gets the
    compressed mean of all of them. The mesh's other axes must have one
    slot. `param_specs` (logical sharding of the leaves) needs
    `runtime/sharding.py`, which is ROADMAP A10's, and is refused."""
    if param_specs is not None:
        raise NotImplementedError("compressed_grad_sync(param_specs=...) resolves logical sharding "
                                  "specs through runtime/sharding.py, which is not ported "
                                  "(ROADMAP A10)")
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no {axis!r}")
    width = mesh.shape[mesh.axis_names.index(axis)]
    if width != mesh.size:
        raise NotImplementedError(f"a mesh {dict(zip(mesh.axis_names, mesh.shape))} with axes beside "
                                  f"{axis!r} (ROADMAP A10)")
    single = isinstance(grads, Mapping)
    per_slot = [grads] if single else list(grads)
    if len(per_slot) != width:
        raise ValueError(f"{len(per_slot)} gradient trees for the {width} slots of axis {axis!r}")
    synced = _map(lambda *xs: compressed_allreduce_mean(xs, cfg, mesh.devices), *per_slot)
    out = [_map(lambda r, i=i: r[i], synced) for i in range(width)]
    return out[0] if single else out


# ---------------------------------------------------------- error feedback --
def ef_init(grads_like: Any) -> Any:
    """Zero float32 residuals shaped like the gradients."""
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like)


def ef_step(grads: Any, residual: Any, cfg: GradCompressionConfig) -> Tuple[Any, Any]:
    """(grads + residual) -> (its quantized view g_hat, the new residual).
    Applied before the compressed collective, so that what travels is the
    error-compensated gradient; the residual stays on the device."""

    def one(g, r):
        tot = g.to(torch.float32) + r
        g_hat = roundtrip(tot, cfg)
        return g_hat.to(g.dtype), tot - g_hat

    pairs = _map(one, grads, residual)
    return _map(lambda pr: pr[0], pairs), _map(lambda pr: pr[1], pairs)
