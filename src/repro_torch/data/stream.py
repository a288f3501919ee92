"""Arrival-pattern simulation (port of `repro/data/stream.py`; paper §4.2,
§5.5.1).

Tuples get monotone timestamps; the default matches the paper's setup
(16e6 bytes/s average). Skewed arrivals use a Zipf-modulated burst process:
zipf_factor 0 => uniform spacing, 1 => heavy bursts + idle gaps. The same
numpy draws as the reference, so both packages replay the same traces.
"""
from __future__ import annotations

import numpy as np

PAPER_ARRIVAL_BYTES_PER_S = 16e6


def uniform_timestamps(n: int, rate_tps: float) -> np.ndarray:
    return np.arange(n, dtype=np.float64) / rate_tps


def zipf_timestamps(n: int, rate_tps: float, zipf_factor: float, seed: int = 3) -> np.ndarray:
    """Bursty arrivals with the same average rate; zipf_factor in [0, 1]."""
    if zipf_factor <= 0:
        return uniform_timestamps(n, rate_tps)
    rng = np.random.default_rng(seed)
    # heavy-tailed inter-arrival gaps, renormalized to the average rate
    a = 1.0 + 1.0 / (0.05 + 2.0 * zipf_factor)
    gaps = rng.zipf(a, n).astype(np.float64)
    gaps = gaps / gaps.mean() / rate_tps
    return np.cumsum(gaps)


def rate_for_dataset(words_per_tuple: int, bytes_per_s: float = PAPER_ARRIVAL_BYTES_PER_S) -> float:
    """Tuples/s matching the paper's 16 MB/s default arrival speed."""
    return bytes_per_s / (4.0 * words_per_tuple)
