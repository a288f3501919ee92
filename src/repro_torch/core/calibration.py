"""Per-stream codec calibration.

The paper tunes lossy codecs per workload (e.g. UANUQ 8 vs 12 qbits, §3.1.1).
On an edge gateway this is a cheap pre-pass over the first micro-batches; here
it is a pure function from a sample window to codec kwargs, used by the engine,
the planner and the data pipeline.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def calibrated_kwargs(name: str, sample: np.ndarray) -> Dict:
    """Codec kwargs tuned to a sample window of the stream."""
    s = np.asarray(sample, dtype=np.float64).ravel()
    if s.size == 0:
        return {}
    # magnitude, not signed max: an all-negative stream would otherwise
    # collapse vmax to 1.0 and undersize the quantizer range
    vmax = float(max(np.abs(s).max(), 1.0))
    if name in ("leb128_nuq", "uanuq"):
        return {"vmax": vmax}
    if name in ("adpcm", "uaadpcm"):
        d = np.abs(np.diff(s)) if s.size > 1 else np.array([1.0])
        dmax = float(max(np.quantile(d, 0.999) * 2.0, 1.0))
        return {"vmax": vmax, "dmax": dmax}
    if name == "pla":
        mean = float(max(abs(s.mean()), 1.0))
        return {"eps": max(1.0, 0.02 * mean)}
    if name == "tdic32":
        # size the hash table to the sample's distinct-value cardinality at
        # ~0.5 load factor (clamped to 2^8..2^16 = 1-256 KiB/lane tables)
        card = np.unique(np.asarray(sample, dtype=np.uint32).ravel()).size
        idx_bits = int(np.clip(np.ceil(np.log2(max(card, 1) * 2.0)), 8, 16))
        return {"idx_bits": idx_bits}
    return {}
