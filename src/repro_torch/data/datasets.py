"""The paper's benchmark workloads (Table 4) as synthetic generators.

The real corpora (MIT-BIH ECG, Rovio telemetry, Chicago beach sensors,
Shanghai stock) are not redistributable/offline; each generator reproduces the
*compressibility structure* the paper relies on — data source count, tuple
layout, stateless compressibility (per-tuple dynamic range) and stateful
compressibility (cross-tuple duplication/smoothness). The Micro dataset is
the paper's own synthetic, with the same two tuning knobs.

All datasets yield `(n_tuples, words_per_tuple)` uint32 arrays; `.stream()`
flattens tuples row-major (the order a gateway sees bytes arrive in).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np


@dataclasses.dataclass
class Dataset:
    name: str
    source: str  # 'single' | 'multiple'
    structure: str  # 'plain' | 'binary' | 'textual'
    words_per_tuple: int
    tuples: np.ndarray  # (N, words_per_tuple) uint32

    def stream(self) -> np.ndarray:
        return self.tuples.reshape(-1)

    @property
    def nbytes(self) -> int:
        return self.tuples.size * 4


def _ecg(n: int, rng) -> np.ndarray:
    """Single-source plain 32-bit ADC trace: smooth baseline + QRS spikes.

    High stateless AND stateful compressibility (11-bit range, strong
    sample-to-sample correlation)."""
    t = np.arange(n)
    baseline = 1024 + 120 * np.sin(2 * np.pi * t / 360.0)
    qrs = np.zeros(n)
    period = 280
    for k in range(0, n, period):
        w = min(12, n - k)
        qrs[k : k + w] += 700 * np.exp(-0.5 * ((np.arange(w) - 6) / 2.5) ** 2)
    noise = rng.normal(0, 6, n)
    x = np.clip(baseline + qrs + noise, 0, 2047).astype(np.uint32)
    return x[:, None]


def _rovio(n: int, rng) -> np.ndarray:
    """Multi-source binary <64b key, 64b payload>: keys from a small hot pool
    (high duplication => stateful/dictionary compressibility), payloads with
    a small dynamic range (stateless compressibility)."""
    keys = rng.zipf(1.4, n).astype(np.uint64) % 4000
    payload = rng.integers(0, 2**18, n, dtype=np.uint64)
    out = np.empty((n, 4), np.uint32)
    out[:, 0] = (keys & 0xFFFFFFFF).astype(np.uint32)
    out[:, 1] = (keys >> 32).astype(np.uint32)
    out[:, 2] = (payload & 0xFFFFFFFF).astype(np.uint32)
    out[:, 3] = (payload >> 32).astype(np.uint32)
    return out


def _sensor(n: int, rng) -> np.ndarray:
    """Multi-source textual: 16 ASCII chars per tuple from a pool of XML-ish
    templates -> low stateless compressibility (full-byte ASCII), high
    stateful compressibility (exact 32-bit word repeats across tuples)."""
    templates = [
        b"<t v='%02d.%01d'/>",
        b"<w s='%02d.%01d'/>",
        b"<h r='%02d.%01d'/>",
    ]
    rows = []
    for i in range(n):
        tpl = templates[int(rng.integers(0, len(templates)))]
        s = tpl % (int(rng.integers(10, 35)), int(rng.integers(0, 10)))
        s = s.ljust(16, b" ")[:16]
        rows.append(np.frombuffer(s, np.uint32))
    return np.stack(rows)


def _stock(n: int, rng) -> np.ndarray:
    """Multi-source binary <32b key, 32b payload>: many distinct keys (less
    duplication than Rovio), price payload = random walk (medium stateful)."""
    keys = rng.zipf(1.1, n).astype(np.uint32) % 60000
    price = np.clip(
        10000 + np.cumsum(rng.integers(-15, 16, n)), 100, 10**6
    ).astype(np.uint32)
    return np.stack([keys, price], axis=1)


def _stock_key(n: int, rng) -> np.ndarray:
    return _stock(n, rng)[:, :1]


def make_micro(
    n: int,
    dynamic_range_bits: int = 16,
    duplication: float = 0.0,
    seed: int = 7,
) -> Dataset:
    """The paper's tunable synthetic [54]: `dynamic_range_bits` controls
    stateless compressibility, `duplication` (0..1, probability a tuple
    repeats a recent one) controls stateful compressibility."""
    rng = np.random.default_rng(seed)
    fresh = rng.integers(0, 2**dynamic_range_bits, n, dtype=np.uint64).astype(np.uint32)
    x = fresh.copy()
    if duplication > 0:
        pool = 64
        dup_mask = rng.random(n) < duplication
        src = rng.integers(1, pool + 1, n)
        # resolve duplication chains against the FINAL stream (a tuple that
        # copies a copied tuple must equal it), so `duplication` is the true
        # exact-repeat probability the stateful codecs can exploit
        for i in np.nonzero(dup_mask & (np.arange(n) >= src))[0]:
            x[i] = x[i - src[i]]
    return Dataset("micro", "single", "plain", 1, x[:, None])


_GENS: Dict[str, Callable] = {
    "ecg": _ecg,
    "rovio": _rovio,
    "sensor": _sensor,
    "stock": _stock,
    "stock_key": _stock_key,
}

#: paper Table 4 metadata
DATASETS = {
    "ecg": ("single", "plain", 1),
    "rovio": ("multiple", "binary", 4),
    "sensor": ("multiple", "textual", 4),
    "stock": ("multiple", "binary", 2),
    "stock_key": ("multiple", "plain", 1),
    "micro": ("single", "plain", 1),
}

#: paper §4.1: metrics averaged over 932800 bytes of tuples
PAPER_EVAL_BYTES = 932800


def make_dataset(name: str, n_tuples: int = 65536, seed: int = 7, **kwargs) -> Dataset:
    if name == "micro":
        return make_micro(n_tuples, seed=seed, **kwargs)
    if name not in _GENS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(_GENS) + ['micro']}")
    source, structure, wpt = DATASETS[name]
    rng = np.random.default_rng(seed)
    return Dataset(name, source, structure, wpt, _GENS[name](n_tuples, rng))
