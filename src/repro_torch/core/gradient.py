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
                                          a `runtime/elastic.DeviceMesh`,
                                          once per group of slots that
                                          share every other coordinate
  ef_init / ef_step                    — error-feedback state

No kernel: the reference quantizes in jnp (`nuq.mulaw_encode_unsigned`),
with no Pallas twin. Gradient trees are dicts of tensors (nested dicts
allowed).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch import compat
from repro_torch.core.algorithms.nuq import mulaw_decode_signed, mulaw_encode_signed


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
    codes = mulaw_encode_signed(xn, cfg.qbits, 1.0, cfg.mu).reshape(-1).to(torch.uint8)
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
    xn = mulaw_decode_signed(codes, cfg.qbits, 1.0, cfg.mu, round_int=False).reshape(-1, cfg.chunk)
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
    and averages. Returns one result per slot, on its device; slots that
    share a device share one result (read-only). The codes and scales that
    leave a slot are counted in `compat.wire_bytes()["compressed"]`."""
    devices = [x.device for x in xs] if devices is None else [torch.device(d) for d in devices]
    shape, dtype = xs[0].shape, xs[0].dtype
    sent = [quantize_tensor(x.to(d), cfg) for x, d in zip(xs, devices)]
    compat.count_bytes("compressed", (len(xs) - 1) * sum(p.numel() + 4 * sc.numel() for p, sc, _ in sent))
    done = {}
    for d in devices:
        if d not in done:
            deq = torch.stack([dequantize_tensor(p.to(d), sc.to(d), n, shape, cfg) for p, sc, n in sent])
            done[d] = torch.mean(deq, dim=0).to(dtype)
    return [done[d] for d in devices]


def _sync_axis_dims(spec, axis: str) -> List[int]:
    """The dims of a physical spec split over exactly `axis` (the
    reference filters a spec down to its `axis` entries)."""
    return [d for d, e in enumerate(spec or ()) if e == axis]


def compressed_grad_sync(grads: Any, mesh, axis: str = "pod",
                         cfg: GradCompressionConfig = GradCompressionConfig(),
                         param_specs: Optional[Any] = None):
    """Synchronize gradients across the `axis` of a port `DeviceMesh`
    (`runtime/elastic.py`) with compression: `grads` is one gradient tree
    per mesh slot (row-major; a single dict for a mesh of one slot,
    returned as a single dict), each on its slot's device and holding the
    whole gradient as that slot sees it. The sync runs once per group of
    slots that share every coordinate but `axis`: every slot of a group
    gets the compressed mean of the group's trees.

    `param_specs` (physical specs keyed like the leaves, as
    `sharding.physical_specs` gives them) are filtered to their `axis`
    entries, as the reference filters its partial-manual `shard_map`
    specs: a dim split over exactly `axis` is cut into one slice per
    slot of the group, each slot's slice averaged with the others' (the
    reference's local views), and the slot outputs joined again. An entry
    naming `axis` among other axes (("pod", "data")) leaves the dim
    whole."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no {axis!r}")
    width = mesh.shape[mesh.axis_names.index(axis)]
    single = isinstance(grads, Mapping)
    per_slot = [grads] if single else list(grads)
    if len(per_slot) != mesh.size:
        raise ValueError(f"{len(per_slot)} gradient trees for the {mesh.size} slots of a "
                         f"{dict(zip(mesh.axis_names, mesh.shape))} mesh")
    out: List[Any] = [None] * mesh.size
    for grp in compat.groups(mesh, (axis,)):
        devs = [mesh.devices[s] for s in grp]

        def leaf(*xs, spec=None):
            dims = _sync_axis_dims(spec, axis)
            if not dims:
                return compressed_allreduce_mean(xs, cfg, devs)
            d = dims[0]
            n = xs[0].shape[d] // width
            parts = compressed_allreduce_mean([x.narrow(d, i * n, n) for i, x in enumerate(xs)], cfg, devs)
            return compat.all_gather(parts, devs, dim=d)

        trees = [per_slot[s] for s in grp]
        if param_specs is None:
            synced = _map(lambda *xs: leaf(*xs), *trees)
        else:
            synced = _map(lambda sp, *xs: leaf(*xs, spec=sp), param_specs, *trees)
        for i, s in enumerate(grp):
            out[s] = _map(lambda r, i=i: r[i], synced)
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
