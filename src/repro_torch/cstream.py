"""`repro_torch.cstream`: the port's public job API (port of
`repro/cstream.py`). The implementation lives in `repro_torch.api`:

    from repro_torch import cstream

    spec = cstream.JobSpec(codec="rle", egress=True)
    with cstream.open(spec, device="cpu") as h:
        h.push(values)
        h.flush()
        report = h.report()

Declarative `JobSpec` in, capability-negotiated `Plan` out (`negotiate`),
one `StreamHandle` for offline compression and wire roundtrips (`open`).
"""
from __future__ import annotations

from repro_torch.api import *  # noqa: F401,F403  (this module IS the public re-export)
from repro_torch.api import __all__  # noqa: F401
