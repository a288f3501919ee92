"""Evaluation metrics (paper §4.1): compression ratio, NRMSE, throughput,
end-to-end latency, and the analytic energy estimate (port of
`repro/core/metrics.py`); `timed`, the wall time of a function."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch


def compression_ratio(input_bits: float, output_bits: float) -> float:
    """loaded data size / compressed data size (paper §2.1)."""
    return float(input_bits) / max(float(output_bits), 1.0)


def nrmse(x, xhat) -> float:
    """NRMSE = sqrt(mean((x - y)^2)) / mean(x)  (paper §4.1)."""
    xf = np.asarray(x, dtype=np.float64)
    yf = np.asarray(xhat, dtype=np.float64)
    denom = max(abs(xf.mean()), 1e-12)
    return float(np.sqrt(np.mean((xf - yf) ** 2)) / denom)


@dataclasses.dataclass
class Fidelity:
    """Reconstruction-fidelity contract check for one roundtrip.

    The egress path's measurement of the paper's 'marginal information
    loss' claim: lossless codecs must come back bit-exact; lossy codecs are
    judged against their configured max-abs error bound when the quantizer
    has one (PLA eps, NUQ level spacing) and reported as measured
    max-abs/RMSE/NRMSE regardless."""

    n_tuples: int
    bit_exact: bool
    max_abs: float
    rmse: float
    nrmse: float
    bound: Optional[float]  # codec's configured max-abs bound (None = no hard bound)

    @property
    def within_bound(self) -> bool:
        """Bit-exact, or inside the codec's hard bound when one exists."""
        if self.bit_exact:
            return True
        if self.bound is None:
            return True  # no hard bound to violate; consult rmse/nrmse
        return self.max_abs <= self.bound + 1e-9

    def row(self) -> str:
        kind = "bit-exact" if self.bit_exact else f"max_abs={self.max_abs:.3g}"
        b = "-" if self.bound is None else f"{self.bound:.3g}"
        return f"{kind},rmse={self.rmse:.4g},nrmse={self.nrmse:.4g},bound={b}"


def fidelity(x, xhat, bound: Optional[float] = None) -> Fidelity:
    """Compare a reconstruction against its source (both uint32 streams)."""
    xf = np.asarray(x, dtype=np.float64).ravel()
    yf = np.asarray(xhat, dtype=np.float64).ravel()
    if xf.size != yf.size:
        raise ValueError(f"length mismatch: {xf.size} vs {yf.size}")
    err = np.abs(xf - yf)
    denom = max(abs(xf.mean()), 1e-12) if xf.size else 1.0
    return Fidelity(
        n_tuples=int(xf.size),
        bit_exact=bool((err == 0).all()) if xf.size else True,
        max_abs=float(err.max()) if xf.size else 0.0,
        rmse=float(np.sqrt(np.mean(err**2))) if xf.size else 0.0,
        nrmse=float(np.sqrt(np.mean(err**2)) / denom) if xf.size else 0.0,
        bound=bound,
    )


@dataclasses.dataclass
class RunStats:
    """One compression run's measurements."""

    name: str
    input_bytes: int
    output_bytes: float
    wall_s: float
    ratio: float
    nrmse: Optional[float] = None
    latency_s: Optional[float] = None  # avg end-to-end per-tuple latency
    energy_j: Optional[float] = None

    @property
    def throughput_mbps(self) -> float:
        return self.input_bytes / 1e6 / max(self.wall_s, 1e-12)

    def row(self) -> str:
        parts = [
            self.name,
            f"{self.ratio:.3f}",
            f"{self.throughput_mbps:.2f}MB/s",
            f"nrmse={self.nrmse:.4f}" if self.nrmse is not None else "lossless",
        ]
        if self.latency_s is not None:
            parts.append(f"lat={self.latency_s*1e3:.3f}ms")
        if self.energy_j is not None:
            parts.append(f"E={self.energy_j:.4f}J")
        return ",".join(parts)


def _wait(result) -> None:
    """Wait for every CUDA tensor in `result` (nested tuples, lists and
    dicts, dataclasses' fields): synchronize each one's device once, as
    `jax.block_until_ready` waits for a result. Nothing to wait for on the
    CPU."""
    devices = set()

    def walk(x) -> None:
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(result)
    for dev in devices:
        torch.cuda.synchronize(dev)


def timed(fn: Callable, *args, warmup: int = 1, iters: int = 3):
    """Wall-time `fn(*args)` after `warmup` calls, waiting for each result's
    tensors; returns (the last result, seconds per call)."""
    result = None
    for _ in range(warmup):
        result = fn(*args)
        _wait(result)
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args)
        _wait(result)
    return result, (time.perf_counter() - t0) / iters
