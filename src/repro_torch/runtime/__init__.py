"""The serving runtime (port of `repro/runtime/`): sessions, the server
core with its gang dispatcher, and the fault-tolerance pieces."""
from repro_torch.runtime.server import (  # noqa: F401
    ServerCore,
    ServerReport,
    SessionReport,
    StreamServer,
    StreamSession,
)
